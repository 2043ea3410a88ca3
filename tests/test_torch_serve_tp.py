"""``serve_model --tp N`` on the CPU: the port's HTTP server over ranks
(``cli/serve_model.py:serve_ranks``, ``serve/api.py``'s plans and
``follow``), each server in its own process as users start it, with rank 0
the server and rank 1 a spawned follower over gloo.

One port-written W8A8 artifact of the repo's tiny Llama (2 layers, f32
compute and KV). Against one rank: ``--tp 2`` and ``--tp 1``, contiguous and
``--paged``, each sent the same concurrent greedy set (a prefix registered
with an integer id, a stop past ``broadcast_requests``' caps, logprobs, an
SSE stream, ``/v1/completions`` with n = 2): tokens equal ``--tp 1``'s and
the static b1 engine's, logprobs bit-equal across the servers (W8A8's
sharded forward has the one-rank bits) and within ``LOGPROB_ATOL`` of the
static engine's. A seeded sampled request goes alone first, so it falls in
the same ticks on both servers: its tokens equal ``--tp 1``'s. Every rank
records its finished requests through the CLI's ``on_finish`` hook
(``LAUNCHER``): the follower's equal rank 0's on every request. Against
JAX: the greedy requests one at a time through
``examples/serve_model.build --tp 2`` on the conftest's virtual CPU mesh
(f32 compute and KV, as here). Lifecycle: an idle spell past the
followers' process group timeout, a client timeout that cancels on both
ranks, malformed requests that fail alone, a follower killed mid-request
(503 and failed requests within ``LOST_WITHIN_S``), SIGINT (exit 0, no
traceback, no rank process left)."""

import atexit

import dataclasses
import importlib.util
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.serve.api import HEARTBEAT_S

from test_torch_util import (http_get, http_post, http_stream, jax_llama,  # noqa: F401
                             one_torch_thread, port_qcfg, to_numpy_tree)

REPO = Path(__file__).resolve().parent.parent
MAX_SEQ = 256
NEW = 8
LOGPROB_ATOL = 1e-5      # logprobs of a server against the static engine (f32)
GROUP_TIMEOUT = 6.0      # the followers' process group timeout (the idle server)
LOST_WITHIN_S = 10.0     # a killed follower fails the request in flight within this
START_TIMEOUT = 240.0    # seconds for a server to print its address
FLAGS = ("--device", "cpu", "--port", "0", "--max-batch", "4", "--max-seq", str(MAX_SEQ),
         "--steps-per-sync", "4")
MODES = {"tp2": ("--tp", "2"), "tp1": ("--tp", "1"),
         "tp2_paged": ("--tp", "2", "--paged", "--block-size", "16"),
         "tp1_paged": ("--tp", "1", "--paged", "--block-size", "16"),
         "lost": ("--tp", "2")}

class RankRecord:
    """What one rank of a server did, as JSON lines in ``path``: each
    finished request's uid, outputs and logprobs, and, when its process
    exits, the uids its engine still holds."""

    def __init__(self, path, eng):
        self.path, self.eng = path, eng
        atexit.register(self.close)

    def write(self, obj):
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(obj) + "\n")

    def on_finish(self, uid, req):
        self.write({"uid": uid, "output": list(req.output), "logprobs": list(req.logprobs)})

    def close(self):
        eng = self.eng
        held = (list(eng.waiting) + [st["req"] for st in eng._admitting.values()]
                + [r for r in eng.slot_req if r is not None])
        self.write({"live": [r.uid for r in held]})


class Record:
    """``serve_model.main``'s ``on_finish`` factory: rank r records into
    rank<r>.jsonl in ``folder``."""

    def __init__(self, folder):
        self.folder = folder

    def __call__(self, eng):
        mesh = getattr(eng, "mesh", None)
        rank = mesh.rank if mesh is not None else 0
        return RankRecord(os.path.join(self.folder, f"rank{rank}.jsonl"), eng).on_finish


# the server's process: the CLI's main with f32 compute and KV, each rank
# recording (argv: the record folder, the followers' group timeout, the flags).
# A file, so that the spawned ranks can unpickle its Record
LAUNCHER = f"""import atexit, json, os, sys
import torch


{inspect.getsource(RankRecord)}

{inspect.getsource(Record)}

if __name__ == "__main__":
    torch.set_num_threads(1)
    from autosmoothquant_tpu_torch.cli import serve_model
    serve_model.main(sys.argv[3:], compute_dtype=torch.float32, kv_dtype=torch.float32,
                     on_finish=Record(sys.argv[1]), group_timeout=json.loads(sys.argv[2]))
"""


def _prompts():
    rng = np.random.default_rng(5)
    greedy = [rng.integers(1, 1000, size=n).tolist() for n in (5, 9, 14, 21, 30, 40)]
    prefix = rng.integers(1, 1000, size=24).tolist()
    return dict(greedy=greedy, prefix=prefix, on_prefix=prefix + [17, 4, 250],
                stop=rng.integers(1, 1000, size=11).tolist(),
                logprobs=rng.integers(1, 1000, size=12).tolist(),
                stream=rng.integers(1, 1000, size=7).tolist(),
                v1=rng.integers(1, 1000, size=6).tolist(),
                sampled=rng.integers(1, 1000, size=8).tolist())


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(path, JAX module, cfg, params, qcfg): the tiny W8A8 Llama written by
    the port's save_quantized."""
    from autosmoothquant_tpu_torch.convert.pipeline import save_quantized

    JL, cfg, params, qcfg = jax_llama({"type": "int8"})
    path = tmp_path_factory.mktemp("tp_art") / "llama-int8"
    save_quantized(str(path), to_numpy_tree(params), port_qcfg(qcfg), config_dict={
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        **dataclasses.asdict(cfg)})
    return path, JL, cfg, params, qcfg


class Server:
    """``serve_model`` in its own process: its port, its pid, the directory
    its ranks record into, and its standard error."""

    def __init__(self, art, mode, tmp):
        self.record = tmp / f"{mode}_record"
        self.record.mkdir()
        self.err = open(tmp / f"{mode}.err", "w+")
        timeout = GROUP_TIMEOUT if mode == "tp2" else None
        launcher = tmp / "serve_launcher.py"
        if not launcher.exists():
            launcher.write_text(LAUNCHER)
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        self.proc = subprocess.Popen(
            [sys.executable, str(launcher), str(self.record), json.dumps(timeout),
             "--quantized-model-path", str(art), *FLAGS, *MODES[mode]],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=self.err, text=True)
        self.port = None

    def wait_ready(self):
        line = {}
        reader = threading.Thread(target=lambda: line.setdefault("l", self.proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(START_TIMEOUT)
        text = line.get("l", "")
        assert text.startswith("[serve_model] llama on 127.0.0.1:"), (text, self.stderr())
        self.port = int(text.split("127.0.0.1:")[1].split()[0])
        return self

    def stderr(self):
        self.err.flush()
        self.err.seek(0)
        return self.err.read()

    def children(self, ranks_only=False):
        """The pids of this server's child processes: its ranks (spawned),
        and multiprocessing's resource tracker unless ``ranks_only``."""
        out = []
        for pid in os.listdir("/proc"):
            if pid.isdigit():
                try:
                    stat = Path(f"/proc/{pid}/stat").read_text()
                    cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
                except OSError:
                    continue
                if (int(stat.rsplit(")", 1)[1].split()[1]) == self.proc.pid
                        and (b"spawn_main" in cmd or not ranks_only)):
                    out.append(int(pid))
        return out

    def records(self, rank):
        """({uid: (outputs, logprobs)} of the requests rank ``rank``
        finished, the uids its engine held at the end)."""
        path = self.record / f"rank{rank}.jsonl"
        lines = list(map(json.loads, path.read_text().splitlines())) if path.exists() else []
        return ({r["uid"]: (r["output"], r["logprobs"]) for r in lines if "uid" in r},
                [r["live"] for r in lines if "live" in r])

    def sigint(self, timeout=60):
        """SIGINT, then (exit code, standard error)."""
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        return rc, self.stderr()


def _alive(pid):
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state != "Z"


@pytest.fixture(scope="module")
def servers(artifact, tmp_path_factory):
    """{mode: Server}, every mode started at once."""
    tmp = tmp_path_factory.mktemp("tp_servers")
    started = {m: Server(artifact[0], m, tmp) for m in MODES}
    try:
        for s in started.values():
            s.wait_ready()
        yield started
    finally:
        for s in started.values():
            if s.proc.poll() is None:
                s.sigint()
            s.err.close()


@pytest.fixture(scope="module")
def static(artifact):
    """The static b1 engine on the artifact (f32): greedy tokens and
    logprobs of a prompt."""
    from autosmoothquant_tpu_torch.cli import load
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    model_mod, _, cfg, params, qcfg = load(str(artifact[0]), "cpu")
    eng = Engine(model_mod, params, cfg, qcfg, max_batch=1, max_seq=MAX_SEQ,
                 kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu")

    def run(prompt, n=NEW):
        return eng.generate([prompt], GenerationConfig(max_new_tokens=n,
                                                       return_logprobs=True))[0]
    return run


def _stop_case(want, stop):
    """(the stop list, the tokens the stop leaves): four 10-token sequences
    that never occur and want[3:5], past broadcast_requests' 4 x 8 caps."""
    seqs = [stop[i:i + 10] for i in range(0, 4)] + [want[3:5]]
    for n in range(1, len(want) + 1):
        if want[:n][-2:] == want[3:5] and n >= 2:
            return seqs, want[:n - 2]
    return seqs, want


def _burst(port, p, stop_list):
    """The concurrent set, sent at once: {name: reply}."""
    calls = {f"greedy{i}": ("/generate", {"prompt": q, "max_new_tokens": NEW})
             for i, q in enumerate(p["greedy"])}
    calls["prefix"] = ("/generate", {"prompt": p["on_prefix"], "max_new_tokens": NEW,
                                     "prefix": 7})
    calls["stop"] = ("/generate", {"prompt": p["stop"], "max_new_tokens": NEW,
                                   "stop": stop_list})
    calls["logprobs"] = ("/generate", {"prompt": p["logprobs"], "max_new_tokens": NEW,
                                       "logprobs": True})
    calls["v1"] = ("/v1/completions", {"prompt": p["v1"], "max_tokens": NEW,
                                       "temperature": 0, "n": 2})
    out = {}

    def one(name):
        path, body = calls[name]
        out[name] = http_post(port, path, body)

    def stream():
        events = http_stream(port, "/generate", {"prompt": p["stream"],
                                                 "max_new_tokens": NEW, "stream": True})
        out["stream"] = (200, json.loads(events[-1][1]))

    threads = [threading.Thread(target=one, args=(n,)) for n in calls]
    threads.append(threading.Thread(target=stream))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    return out


@pytest.fixture(scope="module")
def replies(servers, static):
    """{mode: (sampled reply, burst replies)} of the four comparison
    servers: the sampled request alone first, then the prefix registered
    (integer id), then the burst."""
    p = _prompts()
    want_stop = static(p["stop"])[0]
    stop_list, _ = _stop_case(want_stop, p["stop"])
    out = {}
    for mode in ("tp2", "tp1", "tp2_paged", "tp1_paged"):
        port = servers[mode].port
        sampled = http_post(port, "/generate", {"prompt": p["sampled"], "max_new_tokens": NEW,
                                                "temperature": 0.9, "top_k": 40})
        status, reg = http_post(port, "/prefix", {"id": 7, "tokens": p["prefix"]})
        assert status == 200 and reg["prefix_tokens"] == len(p["prefix"]), (mode, reg)
        out[mode] = (sampled, _burst(port, p, stop_list))
    return out


def _same(body):
    return {k: v for k, v in body.items() if k not in ("id", "created")}


@pytest.mark.parametrize("mode", ["tp2", "tp2_paged"])
def test_tp2_answers_the_burst_as_one_rank_and_the_static_engine(replies, static, mode):
    p = _prompts()
    got, one = replies[mode][1], replies[mode.replace("tp2", "tp1")][1]
    assert set(got) == set(one)
    for name, (status, body) in got.items():
        assert status == 200, (name, body)
        # tokens and logprobs bit-equal; a completion's id and time its own
        assert _same(one[name][1]) == _same(body), name
    for i, q in enumerate(p["greedy"]):
        assert got[f"greedy{i}"][1]["tokens"] == static(q)[0], i
    assert got["prefix"][1]["tokens"] == static(p["on_prefix"])[0]
    assert got["stream"][1]["tokens"] == static(p["stream"])[0]
    want_stop = static(p["stop"])[0]
    _, cut = _stop_case(want_stop, p["stop"])
    assert got["stop"][1]["tokens"] == cut and len(cut) < NEW
    want, want_lp = static(p["logprobs"])
    assert got["logprobs"][1]["tokens"] == want
    np.testing.assert_allclose(got["logprobs"][1]["logprobs"], want_lp, rtol=0,
                               atol=LOGPROB_ATOL)
    choices = got["v1"][1]["choices"]
    assert [c["tokens"] for c in choices] == [static(p["v1"])[0]] * 2


@pytest.mark.parametrize("mode", ["tp2", "tp2_paged"])
def test_a_sampled_request_alone_draws_as_one_rank(replies, mode):
    got, one = replies[mode][0], replies[mode.replace("tp2", "tp1")][0]
    assert got[0] == 200 and len(got[1]["tokens"]) == NEW
    assert got == one


def test_the_jax_cli_at_tp2_gives_the_same_tokens(artifact, replies, monkeypatch):
    """The greedy requests one at a time through ``examples/serve_model.py``'s
    build at --tp 2 on the virtual CPU mesh: tokens equal the port's
    ``--tp 2`` replies."""
    import jax.numpy as jnp
    import autosmoothquant_tpu.serve as jserve
    from autosmoothquant_tpu.serve.batching import ContinuousEngine as JC

    class F32(JC):  # the port's servers here compute and cache in f32
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "compute_dtype": jnp.float32,
                                    "kv_dtype": jnp.float32})

    monkeypatch.setattr(jserve, "ContinuousEngine", F32)
    spec = importlib.util.spec_from_file_location("jax_serve_model",
                                                  REPO / "examples" / "serve_model.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(sys, "argv", ["serve_model.py", "--quantized-model-path",
                                      str(artifact[0]), *FLAGS[2:], "--tp", "2"])
    api, httpd, family = cli.build(cli.parse_args())
    assert family == "llama" and dict(api.engine.mesh.shape) == {"data": 1, "model": 2}
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        p = _prompts()
        got = replies["tp2"][1]
        for i, q in enumerate(p["greedy"]):
            status, out = http_post(httpd.server_address[1], "/generate",
                                    {"prompt": q, "max_new_tokens": NEW})
            assert status == 200 and out["tokens"] == got[f"greedy{i}"][1]["tokens"], i
    finally:
        httpd.shutdown()
        api.stop()
        httpd.server_close()


def test_an_idle_server_outlives_the_followers_group_timeout(servers, replies, static):
    """Idle for longer than the followers' process group timeout (and many
    heartbeats), then a request is answered."""
    time.sleep(GROUP_TIMEOUT + 2 * HEARTBEAT_S)
    q = _prompts()["greedy"][0]
    status, out = http_post(servers["tp2"].port, "/generate", {"prompt": q,
                                                               "max_new_tokens": NEW})
    assert status == 200 and out["tokens"] == static(q)[0]


def test_a_client_timeout_cancels_on_both_ranks(servers, replies, static):
    """A request whose client times out while it decodes is cancelled on
    rank 0 and on the follower: neither finishes it nor holds it at the end
    (the SIGINT test reads the records)."""
    port = servers["tp2"].port
    status, out = http_post(port, "/generate", {"prompt": [3, 1, 4],
                                                "max_new_tokens": MAX_SEQ - 8,
                                                "timeout": 0.3})
    assert status == 400 and "timed out" in out["error"]
    deadline = time.time() + 30
    while http_get(port, "/stats")[1]["active"] and time.time() < deadline:
        time.sleep(0.05)
    q = _prompts()["greedy"][1]
    status, out = http_post(port, "/generate", {"prompt": q, "max_new_tokens": 48})
    assert status == 200 and out["tokens"] == static(q, 48)[0]
    status, stats = http_get(port, "/stats")
    assert stats["active"] == 0 and stats["waiting"] == 0


def test_malformed_requests_fail_alone(servers, replies, static):
    """Token ids past the vocabulary and an unhashable prefix id fail their
    own clients (400), in /generate and in /prefix (a registration and a
    drop); a request sent with them is answered, and /health stays 200."""
    port = servers["tp2"].port
    q = _prompts()["greedy"][2]
    out = {}
    bodies = {"good": ("/generate", {"prompt": q, "max_new_tokens": NEW}),
              "vocab": ("/generate", {"prompt": [5, 5000], "max_new_tokens": NEW}),
              "prefix": ("/generate", {"prompt": [5, 6], "max_new_tokens": NEW,
                                       "prefix": [1, 2]}),
              "register_id": ("/prefix", {"id": [1], "tokens": [1, 2]}),
              "drop_id": ("/prefix", {"id": {"a": 1}, "drop": True}),
              "register_vocab": ("/prefix", {"id": "oov", "tokens": [5, 5000]})}
    threads = [threading.Thread(target=lambda k=k: out.setdefault(k, http_post(
        port, *bodies[k]))) for k in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert out["good"] == (200, {"tokens": static(q)[0], "text": None})
    assert out["vocab"][0] == 400 and "prompt token ids" in out["vocab"][1]["error"]
    assert out["prefix"][0] == 400 and "prefix id" in out["prefix"][1]["error"]
    for name in ("register_id", "drop_id"):
        assert out[name][0] == 400 and "prefix id" in out[name][1]["error"], out[name]
    assert (out["register_vocab"][0] == 400
            and "prefix token ids" in out["register_vocab"][1]["error"]), out["register_vocab"]
    assert http_get(port, "/health")[0] == 200


def test_a_killed_follower_stops_the_server(servers, static):
    """SIGKILL to the follower while a request decodes: the request fails
    with the error's text within LOST_WITHIN_S, /health answers 503, a later
    request fails at once; SIGINT still exits 0 and leaves no process."""
    server = servers["lost"]
    port = server.port
    (follower,) = server.children(ranks_only=True)
    children = server.children()
    got = {}

    def long_request():
        t0 = time.time()
        got["reply"] = http_post(port, "/generate", {"prompt": [3, 1, 4],
                                                     "max_new_tokens": MAX_SEQ - 8})
        got["s"] = time.time() - t0

    th = threading.Thread(target=long_request)
    th.start()
    deadline = time.time() + 60
    while http_get(port, "/stats")[1]["decode_tokens"] == 0 and time.time() < deadline:
        time.sleep(0.01)
    killed = time.time()
    os.kill(follower, signal.SIGKILL)
    th.join(timeout=120)
    status, body = got["reply"]
    assert status == 400 and "engine error" in body["error"], body
    assert time.time() - killed <= LOST_WITHIN_S + 1
    status, health = http_get(port, "/health")
    assert status == 503 and not health["ok"] and health["error"]
    t0 = time.time()
    status, body = http_post(port, "/generate", {"prompt": [1, 2], "max_new_tokens": 2})
    assert status == 400 and health["error"] in body["error"] and time.time() - t0 < 5
    rc, err = server.sigint()
    assert rc == 0, err
    assert not any(_alive(pid) for pid in children)


def test_sigint_ends_every_rank(servers, replies, static):
    """After every other test of the tp2 server: the follower's records equal
    rank 0's on every request (the ranks sampled alike; the cancelled
    request in neither); SIGINT exits 0 with no traceback, and no rank
    process is left."""
    server = servers["tp2"]
    assert len(server.children(ranks_only=True)) == 1
    children = server.children()
    rc, err = server.sigint()
    assert rc == 0 and "Traceback" not in err, err
    assert not any(_alive(pid) for pid in children)
    rank0, rank1 = server.records(0), server.records(1)
    assert rank0[0] and rank0 == rank1
    assert rank0[1] == [[]]   # the cancelled request: held by neither engine
    assert all(len(out) != MAX_SEQ - 8 for out, _ in rank0[0].values())
    s = servers["tp2_paged"]
    rc, err = s.sigint()
    assert rc == 0 and "Traceback" not in err, err
    assert s.records(0)[0] and s.records(0) == s.records(1)
