"""HTTP serving API over the port's continuous-batching engine: the port of
``autosmoothquant_tpu/serve/api.py`` (the standard library and torch), with its
routes, wire shapes, model id and ``owned_by`` strings, so clients see one
server whichever package answers.

A ThreadingHTTPServer accepts requests; one scheduler thread owns the engine
and is the only thread that touches the device: it runs every tick, every
prefix (de)registration, and so every warm-up step and CUDA-graph capture,
all under ``torch.inference_mode()``. Handler threads touch Python objects
only (the loop thread appends tokens and logprobs to each request's lists)
and block on per-request events.

Endpoints:
  POST /generate   {"prompt": [token ids] | "text" (with a tokenizer),
                    "max_new_tokens": int, "temperature": float,
                    "top_k": int, "top_p": float,
                    "repetition_penalty": float, "stop": [[ids...], ...],
                    "logprobs": bool, "stream": bool,
                    "eos_token_id": int|null, "prefix": id|null}
                -> {"tokens": [...], "text": str|null[, "logprobs": [...]]}
                   or (stream=true) text/event-stream: incremental `data:`
                   events then a final `done` event
  POST /prefix  {"id": any-json-key, "tokens": [ids] | "text": str}
                -> {"ok": true, "id": ..., "prefix_tokens": int}
                registers a shared prompt prefix (a system prompt): its KV is
                prefilled once; /generate requests carrying "prefix": id
                whose prompt starts with those tokens copy the cached KV and
                prefill only the suffix. {"id": ..., "drop": true} forgets it.
                429 when the engine's prefix cache is full (PrefixCacheFull),
                400 = bad request, 500 = engine fault.
  GET  /health, /stats  queue depth, slots, token counters, rolling decode
                tok/s; 503 with "ok": false once the device is lost (below)
  POST /v1/completions, /v1/chat/completions  the OpenAI wire shapes (text
                or token-id prompts, n, stop, logprobs, echo, SSE streaming
                ending in `data: [DONE]`, the usage envelope, the OpenAI
                error envelope)
  GET  /v1/models  the served model id
  POST /tokenize {"text": str} -> {"tokens": [ids], "count": n}
  POST /detokenize {"tokens": [ids]} -> {"text": str}

Faults. As in the reference, an exception from a tick fails the requests in
flight, evicts every slot and the server keeps serving: that covers
host-side errors. One difference by design: a CUDA error (a device-side
assert, an illegal address) poisons the process's CUDA context, and every
later device call fails. Once a tick's exception reads as a CUDA error, or
the device no longer synchronizes after it, the scheduler stops driving the
engine: every request in flight and every later request and prefix
registration fails at once with that error's text, and /health answers 503.

Over ranks (an engine whose ``mesh`` spans more than one process, the
reference's ``serve_model --tp``). The server runs on rank 0; every other
rank runs :func:`follow` over its own engine. Each turn of rank 0's
scheduler that has work is one ``serve/multihost.py:TickPlan`` (the drained
prefix operations, cancels and checked submits, and whether it ticks),
broadcast before rank 0 applies it; every rank applies it with
:func:`apply_plan`, so every engine sees the same calls in the same order
and stays in step on the collectives inside its ticks (greedy and sampled
alike where the ranks' logits are bit-equal, as W8A8's are). While idle,
rank 0 sends an empty plan every ``HEARTBEAT_S`` seconds, so no rank waits
longer than that, far inside any process group's timeout. A request that
``submit`` would refuse (``new_request``) and a malformed prefix operation
(``check_prefix``) are checked on rank 0 and fail their client alone; no
rank applies them. Any other exception on any rank
(a rank that dies, or a tick that raises) cannot be shown to leave the
ranks in step, so it stops the server as a lost device does, where the
reference resets its slots and serves on: a follower that raises ends its
process, and rank 0's next collective with it fails (gloo reports a closed
connection at once), or the caller tells rank 0 through :meth:`ServingAPI.lose`.
Stopping rank 0 sends a stop plan, and each follower returns.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from .batching import PrefixCacheFull
from .multihost import TickPlan, broadcast_plan

# seconds between the empty plans an idle server over ranks sends
HEARTBEAT_S = 1.0
# what a prefix registration raises alike on every rank: the registering
# client hears it, and the ranks stay in step
PREFIX_REFUSALS = (PrefixCacheFull, ValueError, AssertionError)


def cuda_context_lost(engine, exc: BaseException) -> bool:
    """Whether the exception a tick raised left the engine's CUDA context
    unusable: its text reads as a CUDA error (torch's "CUDA error: ..." and
    the port's kernel launches both say so; an out-of-memory error does
    not count), or the engine's device no longer synchronizes."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if "CUDA error" in str(exc):
        return True
    device = getattr(engine, "device", None)
    if device is None or device.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(device)
    except Exception:
        return True
    return False


def engine_live(eng) -> bool:
    """Whether the engine holds a request it has not finished."""
    return bool(eng.waiting or eng._admitting
                or any(s is not None for s in eng.slot_req))


def apply_plan(eng, plan: TickPlan, inflight: Dict[Any, Any], ranks: int = 1,
               on_prefix=None, on_submit=None) -> None:
    """Apply one scheduler turn to ``eng``: the prefix operations in order,
    the cancels, the submits, then a tick where ``plan.step``. ``inflight``
    ({uid: Request}) gains the submits and loses the cancels.
    ``on_prefix(i, exc or None)`` hears how prefix operation i went and
    ``on_submit(uid, request)`` each new request. A prefix registration that
    raises goes to ``on_prefix`` alone; over ``ranks`` > 1 only a refusal
    (``PREFIX_REFUSALS``) does, and anything else raises."""
    for i, (pid, toks) in enumerate(plan.prefixes):
        try:
            if toks is None:
                eng.drop_prefix(pid)
            else:
                eng.register_prefix(pid, toks)
        except Exception as e:
            if ranks > 1 and not isinstance(e, PREFIX_REFUSALS):
                raise
            if on_prefix is not None:
                on_prefix(i, e)
            continue
        if on_prefix is not None:
            on_prefix(i, None)
    for uid in plan.cancels:
        inflight.pop(uid, None)
        eng.cancel(uid)
    for uid, prompt, kw in plan.submits:
        inflight[uid] = eng.submit(uid, prompt, **kw)
        if on_submit is not None:
            on_submit(uid, inflight[uid])
    if plan.step:
        eng.step()


def _finished(inflight: Dict[Any, Any]) -> List[Any]:
    return [uid for uid, req in inflight.items() if req.done]


@torch.inference_mode()
def follow(engine, on_finish=None) -> None:
    """A rank other than 0 of a server over ranks: receive rank 0's plans and
    apply them to this rank's ``engine`` (built like rank 0's, on the same
    mesh) until rank 0 stops, then return. Raises where a plan raises or
    rank 0 is gone (its broadcast fails); the caller must then end the
    process, so that rank 0's next collective with it fails too.
    ``on_finish(uid, request)`` sees each finished request; its outputs are
    otherwise discarded."""
    mesh = engine.mesh
    inflight: Dict[Any, Any] = {}
    while True:
        plan = broadcast_plan(None, mesh)
        if plan.stop:
            return
        apply_plan(engine, plan, inflight, mesh.size)
        for uid in _finished(inflight):
            req = inflight.pop(uid)
            if on_finish is not None:
                on_finish(uid, req)


class ServingAPI:
    """Owns a ContinuousEngine and a scheduler thread; thread-safe submit.
    ``fatal`` holds the error text once the device (or a rank) is lost (None
    before). Over ranks (the engine's ``mesh`` spans several) it runs on
    rank 0 and sends each turn to the others (the module's docstring).
    ``on_finish(uid, request)`` sees each finished request; ``plan_log``, a
    list, gets every plan rank 0 applies (applied to another engine in
    order, they make the same calls)."""

    def __init__(self, engine, tokenizer=None, idle_sleep: float = 0.002,
                 on_finish=None, plan_log: Optional[list] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.idle_sleep = idle_sleep
        mesh = getattr(engine, "mesh", None)
        self.ranks = mesh.size if mesh is not None else 1
        if self.ranks > 1 and mesh.rank != 0:
            raise ValueError("the server runs on rank 0; other ranks run follow(engine)")
        self.on_finish = on_finish
        self.plan_log = plan_log
        self._lock = threading.Lock()
        self._inbox: List[dict] = []
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, tuple] = {}
        self._errors: Dict[int, str] = {}
        self._handles: Dict[int, Any] = {}  # uid -> live Request (streaming)
        self._cancels: List[int] = []  # drained by the scheduler thread
        # prefix (de)registrations run a device prefill, so they must run on
        # the scheduler thread (sole device owner): (id, tokens|None, event,
        # errbox) tuples drained each tick
        self._prefix_inbox: List[tuple] = []
        self._uid = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # rolling throughput window: (monotonic time, decode counter) pairs
        # sampled by the scheduler loop, ~last 5 s retained
        self._rate_window: List[tuple] = []
        self.fatal: Optional[str] = None

    # -- client side ---------------------------------------------------------

    def submit_nowait(self, prompt: List[int], **kw):
        """Enqueue and return (uid, event). The live Request appears in
        self._handles[uid] once the scheduler admits it; the event fires on
        completion. Streaming readers poll request.output (the scheduler
        thread only appends; list reads are atomic under the GIL)."""
        ev = threading.Event()
        with self._lock:
            uid = self._uid
            self._uid += 1
            self._events[uid] = ev
            self._inbox.append(dict(uid=uid, prompt=list(prompt), **kw))
        return uid, ev

    def deregister(self, uid: int) -> None:
        """Forget a request (timeout / client gone): the scheduler CANCELS
        it in the engine (no dead decoding) and discards any result — every
        bookkeeping dict is popped here and only here, so cleanup sites
        cannot diverge."""
        with self._lock:
            self._events.pop(uid, None)
            self._results.pop(uid, None)
            self._errors.pop(uid, None)
            self._handles.pop(uid, None)
            self._cancels.append(uid)

    def result(self, uid: int, want_logprobs: bool = False):
        """Collect a finished submit_nowait request (after its event)."""
        with self._lock:
            self._events.pop(uid, None)
            self._handles.pop(uid, None)
            err = self._errors.pop(uid, None)
            if err is not None:
                raise RuntimeError(f"engine error: {err}")
            toks, lps = self._results.pop(uid)
            return (toks, lps) if want_logprobs else toks

    def submit(self, prompt: List[int], *, timeout: Optional[float] = None,
               want_logprobs: bool = False, **kw):
        """Thread-safe blocking generate; returns the new tokens (and
        logprobs when want_logprobs)."""
        uid, ev = self.submit_nowait(prompt, want_logprobs=want_logprobs,
                                     **kw)
        if not ev.wait(timeout):
            self.deregister(uid)
            raise TimeoutError(f"request {uid} timed out")
        return self.result(uid, want_logprobs)

    def register_prefix(self, prefix_id, tokens: Optional[List[int]],
                        timeout: Optional[float] = 600.0) -> None:
        """Thread-safe prefix (de)registration: enqueue for the scheduler
        thread (which owns the device) and block until it ran. tokens=None
        drops the prefix. Raises on engine failure. On timeout the queued
        entry is marked cancelled so the scheduler skips it — a timed-out
        registration never silently takes effect later."""
        ev = threading.Event()
        cancelled = threading.Event()
        errbox: List[str] = []
        with self._lock:
            self._prefix_inbox.append(
                (prefix_id, tokens, ev, errbox, cancelled))
        if not ev.wait(timeout):
            cancelled.set()
            # the scheduler may have started executing in the race window;
            # only guarantee: if it had not started, it never will
            raise TimeoutError("prefix registration timed out")
        if errbox:
            name, _, msg = errbox[0].partition(": ")
            if name == "PrefixCacheFull":
                raise PrefixCacheFull(msg)
            if name in ("ValueError", "AssertionError"):
                raise ValueError(msg)  # client-side validation failure
            raise RuntimeError(f"engine error: {errbox[0]}")

    def stats(self) -> dict:
        """Live serving observability (GET /stats): queue depth, slot and
        page utilization, token counters, rolling decode tok/s (r3 verdict
        item 6 — a serving stack one can see inside without a debugger)."""
        eng = self.engine
        with self._lock:
            waiting = len(self._inbox)
            win = list(self._rate_window)
        toks_per_s = 0.0
        if len(win) >= 2:
            (t0, c0), (t1, c1) = win[0], win[-1]
            if t1 > t0:
                toks_per_s = (c1 - c0) / (t1 - t0)
        out = {"ok": self.fatal is None,
               "active": sum(r is not None for r in eng.slot_req),
               "admitting": len(eng._admitting),
               "waiting": waiting + len(eng.waiting),
               "max_batch": eng.max_batch,
               "prefixes": len(eng._prefixes),
               "max_prefixes": eng.max_prefixes,
               "prefill_tokens": eng.prefill_tokens_processed,
               "decode_tokens": eng.decode_tokens_generated,
               "decode_tok_per_s": round(toks_per_s, 1)}
        if getattr(eng, "speculative_gamma", 0):
            out["spec_gamma"] = eng.speculative_gamma
            out["spec_acceptance_ema"] = round(eng._spec_acc_ema, 3)
        if hasattr(eng, "free_pages"):  # paged engine
            out["free_pages"] = eng.free_pages
            out["num_pages"] = eng.num_pages
            if getattr(eng, "auto_prefix", False):
                out["auto_prefix_blocks"] = eng._auto_pages
                out["auto_prefix_hits"] = eng.auto_hits
                out["auto_prefix_hit_tokens"] = eng.auto_hit_tokens
        if self.fatal is not None:
            out["error"] = self.fatal
        return out

    # -- scheduler thread (sole owner of the engine/device) -------------------

    def _fail_queued(self) -> None:
        """With the device lost: fail every queued request and prefix
        registration at once with the error's text."""
        with self._lock:
            new, self._inbox = self._inbox, []
            prefixes, self._prefix_inbox = self._prefix_inbox, []
            self._cancels = []
            for r in new:
                ev = self._events.get(r["uid"])
                if ev is not None:  # absent = client gone: nothing to tell
                    self._errors[r["uid"]] = self.fatal
                    ev.set()
        for _, _, pev, perr, _ in prefixes:
            perr.append(self.fatal)
            pev.set()

    def _fail(self, uids, err: str) -> None:
        """Fail the waiting clients of ``uids`` with ``err``."""
        with self._lock:
            for uid in uids:
                self._handles.pop(uid, None)
                ev = self._events.get(uid)
                if ev is not None and uid not in self._results:
                    self._errors[uid] = err
                    ev.set()

    def lose(self, err: str) -> None:
        """Stop serving for good (a rank or the device is lost): every
        request in flight or queued, and every later one, fails with
        ``err``'s text, and /health answers 503. Safe from any thread; the
        scheduler drives the engine no more."""
        if self.fatal is None:
            self.fatal = err
        with self._lock:
            uids = list(self._events)
        self._fail(uids, self.fatal)
        self._fail_queued()

    def _drain(self, eng, inflight) -> tuple:
        """Take the inboxes into this turn's plan: (plan, the prefix
        operations' (event, error list) in the plan's order). A request
        ``new_request`` refuses, or a prefix operation ``check_prefix``
        refuses, fails its client here, and a request cancelled in the same
        drain is dropped: none of them reaches any rank."""
        with self._lock:
            new, self._inbox = self._inbox, []
            cancels, self._cancels = self._cancels, []
            prefixes, self._prefix_inbox = self._prefix_inbox, []
        plan = TickPlan(cancels=cancels)
        waiters = []
        for pid, ptoks, pev, perr, pcancel in prefixes:
            if pcancel.is_set():  # registering thread timed out
                continue
            try:
                eng.check_prefix(pid, ptoks)
            except Exception as e:  # its client hears a 400
                perr.append(f"ValueError: {e}")
                pev.set()
                continue
            plan.prefixes.append((pid, None if ptoks is None else list(ptoks)))
            waiters.append((pev, perr))
        cancelled = set(cancels)
        for r in new:
            uid = r.pop("uid")
            if uid in cancelled:
                # deregistered (client timeout) in the same drain:
                # submitting it anyway would decode a zombie whose
                # result nobody collects
                continue
            prompt = r.pop("prompt")
            # a malformed request must fail ONLY its own client — not hang
            # it for its full timeout, and not take the rest of the
            # drained batch down with it
            try:
                eng.new_request(uid, prompt, **r)
            except Exception as e:
                self._fail([uid], f"{type(e).__name__}: {e}")
                continue
            plan.submits.append((uid, prompt, r))
        plan.step = bool(plan.submits or inflight) or engine_live(eng)
        return plan, waiters

    def _sample_rate(self, eng) -> None:
        # rate window advances even when idle (throttled), so /stats decays
        # to 0 instead of reporting the last burst's throughput forever
        now = time.monotonic()
        with self._lock:
            if not self._rate_window or now - self._rate_window[-1][0] > 0.25:
                self._rate_window.append((now, eng.decode_tokens_generated))
            while len(self._rate_window) > 2 and now - self._rate_window[0][0] > 5.0:
                self._rate_window.pop(0)

    @torch.inference_mode()
    def _loop(self):
        eng = self.engine
        mesh = getattr(eng, "mesh", None)
        inflight: Dict[int, Any] = {}
        sent = -math.inf  # when rank 0 last sent a plan: the first turn sends one

        def on_submit(uid, req):
            with self._lock:
                self._handles[uid] = req

        while not self._stop.is_set():
            if self.fatal is not None:
                self._fail_queued()
                time.sleep(self.idle_sleep)
                continue
            plan, waiters = None, []

            def on_prefix(i, exc):
                pev, perr = waiters[i]
                if exc is not None:
                    perr.append(f"{type(exc).__name__}: {exc}")
                pev.set()

            try:
                plan, waiters = self._drain(eng, inflight)
                self._sample_rate(eng)
                if not (plan.prefixes or plan.cancels or plan.submits or plan.step):
                    if self.ranks > 1 and time.monotonic() - sent >= HEARTBEAT_S:
                        broadcast_plan(plan, mesh)
                        sent = time.monotonic()
                    time.sleep(self.idle_sleep)
                    continue
                if self.ranks > 1:
                    broadcast_plan(plan, mesh)
                    sent = time.monotonic()
                if self.plan_log is not None:
                    self.plan_log.append(plan)
                apply_plan(eng, plan, inflight, self.ranks, on_prefix, on_submit)
            except Exception as e:  # fail inflight FAST, keep serving
                traceback.print_exc(file=sys.stderr)
                err = f"{type(e).__name__}: {e}"
                pending = set(inflight)
                if plan is not None:
                    pending |= {uid for uid, _, _ in plan.submits}
                self._fail(pending, err)
                for pev, perr in waiters:
                    if not pev.is_set():
                        perr.append(err)
                        pev.set()
                inflight.clear()
                if self.ranks > 1 or cuda_context_lost(eng, e):
                    # no later device call can succeed, or the ranks may no
                    # longer be in step: stop driving the engine and fail
                    # everything from here on
                    self.lose(err)
                # a poisoned request must not wedge the scheduler: evict
                # every slot so the next tick starts clean
                eng.reset_slots()
                continue
            for uid in _finished(inflight):
                req = inflight.pop(uid)
                if self.on_finish is not None:
                    self.on_finish(uid, req)
                out = req.output
                if (req.eos_token_id is not None
                        and req.eos_token_id in out):
                    out = out[:out.index(req.eos_token_id)]
                with self._lock:
                    ev = self._events.get(uid)
                    if ev is not None:  # absent = client gone: discard
                        n_out = len(out[:req.max_new_tokens])
                        self._results[uid] = (out[:req.max_new_tokens],
                                              req.logprobs[:n_out])
                    else:
                        self._handles.pop(uid, None)
                if ev is not None:
                    ev.set()
        if self.ranks > 1 and self.fatal is None:
            try:  # the other ranks' follow() returns
                broadcast_plan(TickPlan(stop=True), mesh)
            except Exception:
                traceback.print_exc(file=sys.stderr)

    def start(self):
        assert self._thread is None, "already started"
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def _follow(api: ServingAPI, uid: int, ev, holdback: int, deadline: float,
            want_lp: bool):
    """Poll a submitted request and yield its life as events:
    ("chunk", [new token ids...]) as the scheduler appends them (minus the
    holdback tokens a trailing eos/stop could still retract — concatenated
    chunks are always a prefix of the final output), then exactly one of
    ("done", (tokens, logprobs)) or ("error", message)."""
    sent = 0
    while not ev.wait(0.02):
        if time.time() > deadline:
            yield "error", "timeout"
            return
        handle = api._handles.get(uid)
        if handle is None:
            continue
        out = handle.output  # scheduler only appends (GIL-atomic)
        safe = len(out) - holdback
        if safe > sent:
            chunk = out[sent:safe]
            sent = safe
            yield "chunk", chunk
    try:
        res = api.result(uid, want_lp)
    except RuntimeError as e:
        yield "error", str(e)
        return
    yield "done", (res if want_lp else (res, None))


def _opt(req: dict, key: str, default):
    """OpenAI clients send explicit JSON null for 'use the default' —
    int(None)/float(None) must not 500."""
    v = req.get(key, default)
    return default if v is None else v


def _make_handler(api: ServingAPI, model_id: str = "autosmoothquant-tpu"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet test output
            pass

        def _sse(self, event: Optional[str], payload: dict):
            head = f"event: {event}\n" if event else ""
            self.wfile.write(
                (head + "data: " + json.dumps(payload) + "\n\n").encode())
            self.wfile.flush()

        def _stream(self, api, req, prompt, stop, want_lp):
            """Server-sent events: one `data:` event per NEW token batch as
            the scheduler emits them, then a final `done` event with the
            finished (eos/stop-truncated) output.

            Tokens that could still be RETRACTED by end-of-generation
            truncation (a trailing eos, or a partially-matched stop
            sequence) are held back from the incremental events — the
            concatenation of data-event tokens is always a prefix of the
            done event's tokens."""
            uid, ev = api.submit_nowait(
                [int(t) for t in prompt],
                max_new_tokens=int(req.get("max_new_tokens", 64)),
                eos_token_id=req.get("eos_token_id"),
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 1.0)),
                repetition_penalty=float(req.get("repetition_penalty", 1.0)),
                stop=stop, prefix=req.get("prefix"), want_logprobs=want_lp)
            holdback = max((len(s) for s in (stop or [])), default=0)
            if req.get("eos_token_id") is not None:
                holdback = max(holdback, 1)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
            except BaseException:
                # client gone before headers: without this the uid's
                # bookkeeping (and the finished result) leaks forever
                api.deregister(uid)
                raise
            self._streamed = True
            deadline = time.time() + float(_opt(req, "timeout", 600.0))
            try:
                for kind, val in _follow(api, uid, ev, holdback, deadline,
                                         want_lp):
                    if kind == "chunk":
                        text = (api.tokenizer.decode(val)
                                if api.tokenizer is not None else None)
                        self._sse(None, {"tokens": val, "text": text})
                    elif kind == "error":
                        self._sse("error", {"error": val})
                    else:
                        toks, lps = val
                        text = (api.tokenizer.decode(toks)
                                if api.tokenizer is not None else None)
                        payload = {"tokens": toks, "text": text}
                        if want_lp:
                            payload["logprobs"] = lps
                        self._sse("done", payload)
            finally:
                # disconnected clients (BrokenPipeError mid-write) and
                # timeouts must not leave the uid registered, or the
                # scheduler stores the finished result forever
                api.deregister(uid)

        # -- OpenAI-compatible facade (/v1/*) ----------------------------

        def _v1_prompts(self, req) -> List[List[int]]:
            """OpenAI "prompt": text, token ids, or a batch of either."""
            def one(x):
                if isinstance(x, str):
                    if api.tokenizer is None:
                        raise ValueError(
                            "text prompt needs a tokenizer; send token ids")
                    ids = list(api.tokenizer(x).input_ids)
                elif isinstance(x, list) and x and all(
                        isinstance(t, int) and not isinstance(t, bool)
                        for t in x):
                    ids = [int(t) for t in x]
                else:
                    raise ValueError("prompt must be text or a non-empty "
                                     "list of token ids")
                if not ids:
                    raise ValueError("prompt tokenized to zero tokens")
                return ids

            p = req.get("prompt")
            if isinstance(p, list) and p and all(
                    isinstance(x, (str, list)) for x in p):
                return [one(x) for x in p]
            return [one(p)]

        def _v1_stop(self, req):
            """OpenAI "stop": string or list of strings (tokenized), with
            token-id lists accepted as a tokenizer-free extension."""
            s = req.get("stop")
            if s is None:
                return None
            if isinstance(s, (str, int)):
                s = [s]
            out = []
            for item in s:
                if isinstance(item, str):
                    if api.tokenizer is None:
                        raise ValueError("text stop needs a tokenizer; "
                                         "send token-id lists")
                    ids = list(api.tokenizer(item).input_ids)
                elif isinstance(item, int) and not isinstance(item, bool):
                    ids = [int(item)]  # bare stop token id
                elif isinstance(item, list) and item and all(
                        isinstance(t, int) for t in item):
                    ids = [int(t) for t in item]
                else:
                    raise ValueError("stop must be text or token-id lists")
                if ids:
                    out.append(ids)
            return out or None

        def _v1_decode(self, toks):
            return (api.tokenizer.decode(toks)
                    if api.tokenizer is not None else "")

        def _v1_logprobs(self, toks, lps):
            tok_strs = ([self._v1_decode([t]) for t in toks]
                        if api.tokenizer is not None
                        else [str(t) for t in toks])
            return {"tokens": tok_strs, "token_logprobs": lps,
                    "top_logprobs": None, "text_offset": []}

        def _v1_chat_prompt(self, req) -> List[int]:
            """messages -> prompt token ids. Prefers the tokenizer's own
            chat template (HF ``apply_chat_template``); falls back to a
            generic role-header template otherwise."""
            msgs = req.get("messages")
            if not (isinstance(msgs, list) and msgs and all(
                    isinstance(m, dict) and m.get("role") in
                    ("system", "user", "assistant")
                    and isinstance(m.get("content"), str) for m in msgs)):
                raise ValueError(
                    "messages must be a non-empty list of "
                    "{role: system|user|assistant, content: str}")
            if api.tokenizer is None:
                raise ValueError("chat completions need a tokenizer; use "
                                 "/v1/completions with token ids instead")
            tok = api.tokenizer
            if hasattr(tok, "apply_chat_template"):
                try:
                    ids = tok.apply_chat_template(
                        msgs, add_generation_prompt=True, tokenize=True)
                    if ids:
                        return [int(t) for t in ids]
                except Exception:
                    pass  # model ships no template -> generic fallback
            text = "".join(f"<|{m['role']}|>\n{m['content']}\n"
                           for m in msgs) + "<|assistant|>\n"
            ids = list(tok(text).input_ids)
            if not ids:
                raise ValueError("messages tokenized to zero tokens")
            return ids

        def _v1_chat(self, req):
            cid = "chatcmpl-" + uuid.uuid4().hex[:24]
            created = int(time.time())
            base = {"id": cid, "object": "chat.completion",
                    "created": created, "model": model_id}
            prompt = self._v1_chat_prompt(req)
            n = int(req.get("n", 1) or 1)
            if not 1 <= n <= 64:
                raise ValueError("n must be in [1, 64]")
            want_lp = req.get("logprobs") not in (None, False)
            stop = self._v1_stop(req)
            max_toks = int(_opt(req, "max_completion_tokens",
                                _opt(req, "max_tokens", 16)))
            kw = dict(max_new_tokens=max_toks,
                      eos_token_id=req.get("eos_token_id"),
                      temperature=float(_opt(req, "temperature", 1.0)),
                      top_k=int(_opt(req, "top_k", 0)),
                      top_p=float(_opt(req, "top_p", 1.0)),
                      repetition_penalty=float(
                          _opt(req, "repetition_penalty", 1.0)),
                      stop=stop, want_logprobs=want_lp)
            deadline = time.time() + float(_opt(req, "timeout", 600.0))
            if bool(req.get("stream", False)):
                if n != 1:
                    raise ValueError("stream=true supports n=1")
                include_usage = bool(
                    (req.get("stream_options") or {}).get("include_usage"))
                self._v1_chat_stream(base, prompt, kw, deadline, max_toks,
                                     include_usage)
                return
            subs = [api.submit_nowait(list(prompt), **kw) for _ in range(n)]
            choices, completion_tokens = [], 0
            try:
                for i, (uid, ev) in enumerate(subs):
                    if not ev.wait(max(deadline - time.time(), 0.001)):
                        raise TimeoutError(f"completion {i} timed out")
                    res = api.result(uid, want_lp)
                    toks, lps = res if want_lp else (res, None)
                    completion_tokens += len(toks)
                    choices.append({
                        "index": i,
                        "message": {"role": "assistant",
                                    "content": self._v1_decode(toks)},
                        "tokens": toks,
                        "logprobs": (self._v1_logprobs(toks, lps)
                                     if want_lp else None),
                        "finish_reason": ("length" if len(toks) >= max_toks
                                          else "stop")})
            finally:
                for uid, _ in subs:
                    api.deregister(uid)
            self._send(200, {
                **base, "choices": choices,
                "usage": {"prompt_tokens": len(prompt),
                          "completion_tokens": completion_tokens,
                          "total_tokens": len(prompt)
                          + completion_tokens}})

        def _v1_chat_stream(self, base, prompt, kw, deadline, max_toks,
                            include_usage=False):
            """chat.completion.chunk stream: role-opening delta, content
            deltas, a finish_reason chunk (carrying the full completion's
            logprobs when requested), then `data: [DONE]`."""
            base = {**base, "object": "chat.completion.chunk"}
            want_lp = kw["want_logprobs"]
            uid, ev = api.submit_nowait(list(prompt), **kw)
            holdback = max((len(s) for s in (kw["stop"] or [])), default=0)
            if kw["eos_token_id"] is not None:
                holdback = max(holdback, 1)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
            except BaseException:
                api.deregister(uid)  # client gone before headers: no leak
                raise
            self._streamed = True

            def chunk(delta, finish, logprobs=None):
                c = {"index": 0, "delta": delta, "logprobs": logprobs,
                     "finish_reason": finish}
                self.wfile.write(("data: " + json.dumps(
                    {**base, "choices": [c]}) + "\n\n").encode())
                self.wfile.flush()

            sent = 0
            try:
                chunk({"role": "assistant", "content": ""}, None)
                for kind, val in _follow(api, uid, ev, holdback, deadline,
                                         want_lp):
                    if kind == "chunk":
                        sent += len(val)
                        chunk({"content": self._v1_decode(val)}, None)
                    elif kind == "error":
                        self.wfile.write(("data: " + json.dumps(
                            {**base, "error": val}) + "\n\n").encode())
                        return
                    else:
                        toks, lps = val
                        tail = toks[sent:]
                        if tail:
                            chunk({"content": self._v1_decode(tail)}, None)
                        chunk({}, "length" if len(toks) >= max_toks
                              else "stop",
                              (self._v1_logprobs(toks, lps)
                               if want_lp and lps is not None else None))
                        if include_usage:
                            self.wfile.write(("data: " + json.dumps({
                                **base, "choices": [], "usage": {
                                    "prompt_tokens": len(prompt),
                                    "completion_tokens": len(toks),
                                    "total_tokens": len(prompt)
                                    + len(toks)}}) + "\n\n").encode())
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            finally:
                api.deregister(uid)

        def _v1_completions(self, req):
            cid = "cmpl-" + uuid.uuid4().hex[:24]
            created = int(time.time())
            base = {"id": cid, "object": "text_completion",
                    "created": created, "model": model_id}
            prompts = self._v1_prompts(req)
            n = int(req.get("n", 1) or 1)
            if not 1 <= n <= 64:
                raise ValueError("n must be in [1, 64]")
            want_lp = req.get("logprobs") not in (None, False)
            echo = bool(req.get("echo", False))
            stop = self._v1_stop(req)
            max_toks = int(_opt(req, "max_tokens", 16))
            kw = dict(max_new_tokens=max_toks,
                      eos_token_id=req.get("eos_token_id"),
                      # OpenAI semantics: temperature defaults to 1
                      # (sampling); 0 falls through to the engine's greedy
                      temperature=float(_opt(req, "temperature", 1.0)),
                      top_k=int(_opt(req, "top_k", 0)),
                      top_p=float(_opt(req, "top_p", 1.0)),
                      repetition_penalty=float(
                          _opt(req, "repetition_penalty", 1.0)),
                      stop=stop, want_logprobs=want_lp)
            deadline = time.time() + float(_opt(req, "timeout", 600.0))
            if bool(req.get("stream", False)):
                if len(prompts) != 1 or n != 1:
                    raise ValueError(
                        "stream=true supports a single prompt with n=1")
                include_usage = bool(
                    (req.get("stream_options") or {}).get("include_usage"))
                self._v1_stream(base, prompts[0], kw, deadline, want_lp,
                                max_toks, include_usage)
                return
            # one engine request per (prompt, sample): they decode as one
            # continuous batch; choices index prompt-major like OpenAI
            subs = [api.submit_nowait(list(p), **kw)
                    for p in prompts for _ in range(n)]
            choices, completion_tokens = [], 0
            try:
                for i, (uid, ev) in enumerate(subs):
                    if not ev.wait(max(deadline - time.time(), 0.001)):
                        raise TimeoutError(f"completion {i} timed out")
                    res = api.result(uid, want_lp)
                    toks, lps = res if want_lp else (res, None)
                    completion_tokens += len(toks)
                    text = self._v1_decode(toks)
                    if echo:
                        text = self._v1_decode(prompts[i // n]) + text
                    choices.append({
                        "index": i, "text": text, "tokens": toks,
                        "logprobs": (self._v1_logprobs(toks, lps)
                                     if want_lp else None),
                        "finish_reason": ("length" if len(toks) >= max_toks
                                          else "stop")})
            finally:
                for uid, _ in subs:
                    api.deregister(uid)
            # OpenAI counts prompt tokens once per request, NOT once per
            # sampled choice
            prompt_tokens = sum(len(p) for p in prompts)
            self._send(200, {
                **base, "choices": choices,
                "usage": {"prompt_tokens": prompt_tokens,
                          "completion_tokens": completion_tokens,
                          "total_tokens": prompt_tokens + completion_tokens}})

        def _v1_stream(self, base, prompt, kw, deadline, want_lp, max_toks,
                       include_usage=False):
            """OpenAI streaming: `data: {chunk}` events whose choices carry
            text deltas, a final chunk with finish_reason, an optional
            usage chunk (stream_options.include_usage), then
            `data: [DONE]`."""
            uid, ev = api.submit_nowait(list(prompt), **kw)
            holdback = max((len(s) for s in (kw["stop"] or [])), default=0)
            if kw["eos_token_id"] is not None:
                holdback = max(holdback, 1)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
            except BaseException:
                api.deregister(uid)  # client gone before headers: no leak
                raise
            self._streamed = True

            def chunk(text, finish, toks, lps=None):
                c = {"index": 0, "text": text, "tokens": toks,
                     "logprobs": (self._v1_logprobs(toks, lps)
                                  if want_lp and lps is not None else None),
                     "finish_reason": finish}
                self.wfile.write(("data: " + json.dumps(
                    {**base, "choices": [c]}) + "\n\n").encode())
                self.wfile.flush()

            sent = 0
            try:
                for kind, val in _follow(api, uid, ev, holdback, deadline,
                                         want_lp):
                    if kind == "chunk":
                        sent += len(val)
                        chunk(self._v1_decode(val), None, val)
                    elif kind == "error":
                        self.wfile.write(("data: " + json.dumps(
                            {**base, "error": val}) + "\n\n").encode())
                        return
                    else:
                        toks, lps = val
                        tail = toks[sent:]
                        # logprobs must stay aligned with the chunk's own
                        # tokens — the tail slice, not the full request
                        chunk(self._v1_decode(tail),
                              "length" if len(toks) >= max_toks else "stop",
                              tail, lps[sent:] if lps else lps)
                        if include_usage:
                            # OpenAI stream_options.include_usage: one
                            # final chunk with empty choices + usage
                            self.wfile.write(("data: " + json.dumps({
                                **base, "choices": [], "usage": {
                                    "prompt_tokens": len(prompt),
                                    "completion_tokens": len(toks),
                                    "total_tokens": len(prompt)
                                    + len(toks)}}) + "\n\n").encode())
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            finally:
                api.deregister(uid)

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/health", "/stats"):
                stats = api.stats()
                self._send(200 if stats["ok"] else 503, stats)
            elif self.path == "/v1/models":
                self._send(200, {"object": "list", "data": [
                    {"id": model_id, "object": "model",
                     "owned_by": "autosmoothquant-tpu"}]})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            # once a streaming handler has sent its status line + SSE
            # headers, error reporting must NOT emit a second HTTP status
            # into the same byte stream (client-disconnect BrokenPipeError
            # lands here too — swallow it, the connection is gone)
            self._streamed = False
            if self.path in ("/v1/completions", "/v1/chat/completions"):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path.endswith("/chat/completions"):
                        self._v1_chat(req)
                    else:
                        self._v1_completions(req)
                except (ValueError, json.JSONDecodeError) as e:
                    if self._streamed:
                        return
                    # OpenAI error envelope so standard clients parse it
                    self._send(400, {"error": {
                        "message": str(e), "type": "invalid_request_error",
                        "param": None, "code": None}})
                except Exception as e:
                    if self._streamed:
                        return
                    self._send(500, {"error": {
                        "message": f"{type(e).__name__}: {e}",
                        "type": "server_error", "param": None, "code": None}})
                return
            if self.path in ("/tokenize", "/detokenize"):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if api.tokenizer is None:
                        raise ValueError("no tokenizer configured")
                    if self.path == "/tokenize":
                        if not isinstance(req.get("text"), str):
                            raise ValueError("tokenize needs {'text': str}")
                        toks = [int(t) for t in
                                api.tokenizer(req["text"]).input_ids]
                        self._send(200, {"tokens": toks,
                                         "count": len(toks)})
                    else:
                        toks = req.get("tokens")
                        if not (isinstance(toks, list) and all(
                                isinstance(t, int) for t in toks)):
                            raise ValueError(
                                "detokenize needs {'tokens': [ids]}")
                        self._send(200, {
                            "text": api.tokenizer.decode(toks)})
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    self._send(500, {"error": "tokenizer failure"})
                return
            if self.path == "/prefix":
                # status mapping: 400 = request validation, 429 = prefix
                # cache at capacity (retry after dropping one), 500 =
                # engine/timeout fault (internal; no raw engine text leaked)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if "id" not in req:
                        raise ValueError("prefix registration needs an id")
                    if req.get("drop"):
                        api.register_prefix(req["id"], None)
                        self._send(200, {"ok": True, "id": req["id"],
                                         "dropped": True})
                        return
                    toks = req.get("tokens")
                    if toks is None and isinstance(req.get("text"), str):
                        if api.tokenizer is None:
                            raise ValueError(
                                "text prefix needs a tokenizer; send ids")
                        toks = api.tokenizer(req["text"]).input_ids
                    if not isinstance(toks, list) or not toks or not all(
                            isinstance(t, int) for t in toks):
                        raise ValueError(
                            "tokens must be a non-empty list of ints")
                    api.register_prefix(req["id"], toks)
                    self._send(200, {"ok": True, "id": req["id"],
                                     "prefix_tokens": len(toks)})
                except PrefixCacheFull:
                    self._send(429, {"error": "prefix cache full; "
                                     "drop a prefix and retry"})
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    self._send(500, {"error": "prefix registration failed"})
                return
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req.get("prompt")
                if isinstance(prompt, str):
                    if api.tokenizer is None:
                        raise ValueError(
                            "text prompt needs a tokenizer; send token ids")
                    prompt = api.tokenizer(prompt).input_ids
                if not isinstance(prompt, list) or not prompt:
                    raise ValueError("prompt must be a non-empty list or text")
                stop = req.get("stop")
                if stop is not None and not (
                        isinstance(stop, list) and all(
                            isinstance(s, list) and s
                            and all(isinstance(t, int) for t in s)
                            for s in stop)):
                    raise ValueError(
                        "stop must be a list of token-id lists")
                want_lp = bool(req.get("logprobs", False))
                if bool(req.get("stream", False)):
                    self._stream(api, req, prompt, stop, want_lp)
                    return
                res = api.submit(
                    [int(t) for t in prompt],
                    max_new_tokens=int(req.get("max_new_tokens", 64)),
                    eos_token_id=req.get("eos_token_id"),
                    temperature=float(req.get("temperature", 0.0)),
                    top_k=int(req.get("top_k", 0)),
                    top_p=float(req.get("top_p", 1.0)),
                    repetition_penalty=float(
                        req.get("repetition_penalty", 1.0)),
                    stop=stop,
                    prefix=req.get("prefix"),
                    want_logprobs=want_lp,
                    timeout=float(req.get("timeout", 600.0)))
                toks, lps = res if want_lp else (res, None)
                text = (api.tokenizer.decode(toks)
                        if api.tokenizer is not None else None)
                payload = {"tokens": toks, "text": text}
                if want_lp:
                    payload["logprobs"] = lps
                self._send(200, payload)
            except Exception as e:  # surface as a JSON error, keep serving
                if self._streamed:  # SSE already underway: no 2nd status
                    return
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of more clients
    # connecting at once than that has connections reset before a handler
    # thread sees them (the reference server keeps that default)
    request_queue_size = 1024


def serve(engine, host: str = "127.0.0.1", port: int = 8000, tokenizer=None,
          model_id: str = "autosmoothquant-tpu", **api_kw) -> tuple:
    """Start the scheduler thread + HTTP server; returns (api, httpd).
    Callers run ``httpd.serve_forever()`` (or poke it from tests) and shut
    down with ``httpd.shutdown(); api.stop()``. ``model_id`` is what
    /v1/models and completion envelopes report; ``api_kw`` go to
    :class:`ServingAPI` (``on_finish``, ``plan_log``). Over
    ranks this runs on rank 0, and every other rank runs :func:`follow`."""
    api = ServingAPI(engine, tokenizer=tokenizer, **api_kw).start()
    httpd = _Server((host, port), _make_handler(api, model_id))
    return api, httpd
