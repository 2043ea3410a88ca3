"""Microbatched pipeline parallelism (the GPipe schedule) over the "stage"
axis: the port of ``autosmoothquant_tpu/shard/pipeline.py``.

JAX runs the schedule in one process: a ``vmap`` over a stage-sharded
activation buffer, with ``jnp.roll`` lowered to a collective permute. Here
each rank is one stage, at its coordinate s on the mesh's "stage" axis
(``shard/mesh.py``), and holds only its contiguous layers
[s L / S, (s + 1) L / S) (:func:`stage_stack`, as
``shard/sharding.py:shard_params`` places them):

  - M microbatches finish in M + S - 1 ticks: at tick t stage s runs
    microbatch t - s where 0 <= t - s < M, through its layers one at a
    time (the family's ``_layer_forward``, plain causal, no cache: a
    Llama-family layer hands the next its MLP output still to add, which
    the next norm folds in), and posts the completed sum to stage s + 1
    (``Axis.send``, which returns at once, so a stage computes its next
    microbatch while the last one travels);
  - stage 0 embeds (the family's ``embed``: OPT's ``project_in`` and learned
    positions too); the last stage applies the head (the family's ``head``:
    the final norm, with the last layer's add folded in, OPT's
    ``project_out``) and returns the final hidden
    state, which the other stages do not have (they return None);
  - every rank of a stage line posts the same sends and receives in the
    same order (stage s sends M tensors to s + 1, which receives M), so no
    rank waits on one that waits on it. A rank that raises ends its
    ``shard/mesh.py:launch``, which kills the others with its traceback.

"model" composes inside a stage (each stage's layers tensor-parallel in its
model group, as the one-stage forward under a mesh); "data" splits each
microbatch's rows, and the last stage gathers them back in order. Without a
mesh, or at one stage, the schedule runs on one rank and equals the
family's ``forward``.

Under gloo a CUDA hidden state goes to the host for each send and back
after each receive (``Axis.send`` / ``recv``); NCCL sends device tensors.

Unlike JAX, which turns its fused Pallas blocks off on this path, the port
keeps K2 and K6 here as on every device: they compute what their plain
versions do, row by row, so a microbatch's rows are the whole batch's. The
W8A8 arithmetic is row-alone or exact (K1 accumulates in int32; K2, K3 and
``rmsnorm_quant`` sum a row alone), so the pipelined W8A8 forward has the
one-rank forward's bits. A sliding window (Mistral) masks as the family's
forward does, where JAX's schedule passes a plain causal mask.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from .mesh import Mesh, axis_of


def stage_stack(layers, num_stages: int) -> List[list]:
    """The layer list cut into ``num_stages`` contiguous blocks, stage-major:
    stage i holds layers [i L / S, (i + 1) L / S) (JAX's [L, ...] ->
    [S, L/S, ...]). Layers that do not divide raise ValueError."""
    n = len(layers)
    if n % num_stages:
        raise ValueError(f"{n} layers not divisible by {num_stages} stages")
    per = n // num_stages
    return [list(layers[i * per:(i + 1) * per]) for i in range(num_stages)]


def pipeline_layers(feed: Callable[[int], torch.Tensor], microbatches: int, layers,
                    step_fn: Callable, mesh: Optional[Mesh], shape, dtype,
                    device) -> List[Optional[tuple]]:
    """Run this rank's part of the GPipe schedule. ``feed(i)``: microbatch
    i's input (called on the first stage only); ``layers``: this rank's
    layers; ``step_fn(h, pending, lp)`` applies one layer and returns (h,
    pending), ``pending`` a branch output not yet added to h (None: h is
    whole); ``shape`` and ``dtype``: a microbatch's hidden state, as a later
    stage receives it (the completed sum h + pending). Returns the M
    microbatches' (h, pending) on the last stage, None elsewhere."""
    from ..models.common import complete

    st = axis_of(mesh, "stage")
    s, n = st.index, st.size
    outs: List[Optional[tuple]] = [None] * microbatches
    for tick in range(microbatches + n - 1):
        i = tick - s
        if not 0 <= i < microbatches:
            continue
        h = feed(i) if s == 0 else st.recv(shape, dtype, device, s - 1)
        pending = None
        for lp in layers:
            h, pending = step_fn(h, pending, lp)
        if s < n - 1:
            st.send(complete(h, pending), s + 1)
        else:
            outs[i] = (h, pending)
    st.wait_sends()
    return outs


def _uncached(mb: int, t: int, device, window: int = 0):
    """(positions, mask, plain_causal) of the family's uncached forward."""
    from ..models.common import uncached_mask_and_positions

    return uncached_mask_and_positions(mb, t, None, None, window, device)


def _rope_step(mod, cfg, qcfg, mb, t, compute_dtype, plan, mesh, device):
    """Llama's, Gemma's and Mixtral's layer (one signature in the port)."""
    from ..models.common import rope_cos_sin

    positions, mask, plain = _uncached(mb, t, device, getattr(cfg, "sliding_window", 0))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    def step(h, pending, lp):
        return mod._layer_forward(h, lp, cfg, qcfg, cos, sin, mask, None, None, compute_dtype,
                                  pending=pending, plain_causal=plain, plan=plan, mesh=mesh)

    return step


def _baichuan_step(mod, cfg, qcfg, mb, t, compute_dtype, plan, mesh, device):
    from ..models.common import rope_cos_sin

    positions, mask, plain = _uncached(mb, t, device)
    cos = sin = None
    if cfg.position_embedding == "ROPE":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    slopes = plan.slopes(mod.slopes_on(cfg, device))

    def step(h, pending, lp):
        return mod._layer_forward(h, lp, cfg, qcfg, cos, sin, mask, None, None, compute_dtype,
                                  slopes, pending=pending, plain_causal=plain, plan=plan,
                                  mesh=mesh)

    return step


def _opt_step(mod, cfg, qcfg, mb, t, compute_dtype, plan, mesh, device):
    _, mask, plain = _uncached(mb, t, device)

    def step(h, pending, lp):  # OPT's layer completes its own sum
        return mod._layer_forward(h, lp, cfg, qcfg, mask, None, None, compute_dtype,
                                  plain_causal=plain, plan=plan, mesh=mesh), None

    return step


_STEP_BUILDERS = {
    "llama": _rope_step,
    "gemma": _rope_step,        # the Llama layer (models/gemma.py)
    "mixtral": _rope_step,
    "baichuan": _baichuan_step,
    "transformers": _opt_step,  # OPT's family tag
}


def pipelined_forward(model, params, input_ids: torch.Tensor, cfg, quant_config=None, *,
                      mesh: Optional[Mesh] = None, microbatches: int = 4,
                      compute_dtype: Any = torch.float32) -> Optional[torch.Tensor]:
    """Cacheless causal forward (perplexity windows, scoring) with the layer
    stack run as a microbatched pipeline over the mesh's "stage" axis.
    ``model``: a family module; ``params``: this rank's shard
    (``shard_params`` under ``with_stage_axis`` specs), or the whole params
    without a mesh; ``input_ids`` [B, T], the whole batch on every rank. The
    model's final hidden state [B, T, D] in compute_dtype, equal to
    ``model.forward(...)[0]``, on the last stage; None on the others.
    B must divide into ``microbatches``, and a microbatch's rows over the
    "data" axis (ValueError otherwise)."""
    from ..models.common import forward_plan

    family = model.FAMILY
    b, t = input_ids.shape
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by {microbatches} microbatches")
    mb = b // microbatches
    dax = axis_of(mesh, "data")
    if mb % dax.size:
        raise ValueError(f"a microbatch's {mb} rows do not split over {dax.size} data ranks")
    rows = mb // dax.size
    st = axis_of(mesh, "stage")
    layers = params["layers"]
    if len(layers) * st.size != cfg.num_hidden_layers:
        raise ValueError(f"{len(layers)} layers a rank over {st.size} stages; the model has "
                         f"{cfg.num_hidden_layers} (shard the params for the mesh)")
    plan = forward_plan(family, cfg, mesh, quant_config)
    dev = input_ids.device
    step = _STEP_BUILDERS[family](model, cfg, quant_config, rows, t, compute_dtype, plan,
                                  mesh, dev)

    def feed(i):
        lo = i * mb + dax.index * rows
        return model.embed(params, input_ids[lo:lo + rows], cfg, compute_dtype)

    outs = pipeline_layers(feed, microbatches, layers, step, mesh, (rows, t, cfg.hidden_size),
                           compute_dtype, dev)
    if st.index < st.size - 1:
        return None
    heads = [model.head(params, h, cfg, compute_dtype, pending=pending) for h, pending in outs]
    return torch.cat([dax.all_gather(x, dim=0) for x in heads])
