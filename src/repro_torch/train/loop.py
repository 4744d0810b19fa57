"""Training step construction (mirrors ``repro.train.loop``): loss, grad
accumulation, clipping, optimizer.

    model = init_model(cfg, generator, device=device)
    state = TrainState(opt_state=opt.init(model.param_dict()), step=0)
    step = make_train_step(cfg, model, opt)
    state, metrics = step(state, pipe.batch_at(i))

The optimizer's masters are the model's parameters (``Block8bitOptimizer``
updates them in place), so the step needs no params view: the forward of
step i+1 reads what ``apply`` wrote in step i.  Under the pooled layout the
global-norm clip writes each quantized leaf's clipped gradient straight
into the arena's gradient buffer (``optimizer.grad_views``), the same
product the in-place clip computes, so ``apply`` gathers nothing.

With the optimizer's numerics sentinel on (``OptimConfig.sentinel``), the
step's metrics also carry the summed health counts as ``sent_<slot>``
(``kernels/fused_update.HEALTH_SLOTS``); with percentile clipping on, the
clip's scale as ``pclip_scale``.  The two phases of the step are wrapped in
``telemetry.tracing.annotate`` ("forward_backward", "optimizer_update"),
a no-op unless phase tracing is on.

**Data parallel and ZeRO-2.**  An optimizer built on a mesh
(``make_optimizer(..., mesh=)``, its ``data_parallel`` group of W ranks)
makes every rank train on its own W-th of the batch's rows; each
microbatch's gradients are reduced by the optimizer
(``accumulate_grads``: reduce-scattered into the padded span layout and
divided by W, the ride-along leaves all-reduced), one way for every mode.
ZeRO-2 (``shard_grads``, in one process too) then clips and applies from
the accumulated :class:`~repro_torch.core.optim.blockopt.GradBuffer`, its
norm from ``grad_buffer_norm``; the other modes all-gather the reduced
gradient back (``gather_grads``) and clip it in place.  The loss is the
mean over the ranks.  The metrics gain ``opt_owned_blocks`` and
``opt_owned_state_bytes_per_param`` under a partition, and
``peak_grad_bytes`` / ``replicated_grad_bytes`` under ZeRO-2.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.analysis import contracts as _contracts
from repro_torch.kernels import fused_update as kfu
from repro_torch.kernels import ops as kops
from repro_torch.models import constrain as constrain_lib
from repro_torch.models import model as M
from repro_torch.telemetry import tracing


class TrainState(NamedTuple):
    """The optimizer state (masters = the model's parameters, 8-bit
    statistics, clipping history) and the step count."""
    opt_state: Any
    step: int


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    grad_clip: float = 1.0
    microbatches: int = 1
    label_smoothing: float = 0.0
    moe_aux_coef: float = 0.01
    moe_z_coef: float = 1e-3
    lr_schedule: Optional[Callable[[int], Any]] = None


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token loss of this device's vocab shard ``x`` (b, S, V/tp) f32,
    as the JAX package's ``logsumexp`` and masked gold sum reduce under
    GSPMD (Megatron-LM's vocab-parallel cross entropy): the local max
    all-reduced MAX over the tp ``group`` (no gradient, as in any stable
    logsumexp), then the local sum of ``exp(x - m)``, the gold logit (the
    label offset by the shard's first vocab index ``offset``; zero where
    the label lies in another shard) and, with ``smoothing``, the sum of
    the logits, stacked and all-reduced SUM.  Returns the (b, S) loss,
    ``logz - (1 - s) gold - s sum / V``: the unsharded expression.  The
    backward, ``softmax - (1 - s) onehot - s / V`` on the shard times the
    loss's gradient, moves nothing across the group."""

    @staticmethod
    def forward(ctx, x, labels, offset: int, vocab: int, smoothing: float,
                group):
        from torch.distributed import _functional_collectives as funcol
        Vl = x.shape[-1]
        m = funcol.wait_tensor(funcol.all_reduce(x.amax(dim=-1), "max",
                                                 group))
        idx = labels.long() - offset
        mine = (idx >= 0) & (idx < Vl)
        idx = idx.clamp(0, Vl - 1)
        gold = torch.where(mine, x.gather(-1, idx[..., None])[..., 0], 0.0)
        parts = [torch.sub(x, m[..., None]).exp_().sum(dim=-1), gold]
        if smoothing > 0.0:
            parts.append(x.sum(dim=-1))
        sums = funcol.wait_tensor(funcol.all_reduce(torch.stack(parts), "sum",
                                                    group))
        logz = m + torch.log(sums[0])
        nll = logz - (1 - smoothing) * sums[1]
        if smoothing > 0.0:
            nll = nll - (smoothing / vocab) * sums[2]
        ctx.save_for_backward(x, logz, idx, mine)
        ctx.smoothing, ctx.vocab = smoothing, vocab
        return nll

    @staticmethod
    def backward(ctx, g):
        x, logz, idx, mine = ctx.saved_tensors
        s = ctx.smoothing
        grad = torch.sub(x, logz[..., None]).exp_()
        if s > 0.0:
            grad.sub_(s / ctx.vocab)
        grad.scatter_add_(-1, idx[..., None],
                          (mine.to(grad.dtype) * (s - 1.0))[..., None])
        return grad.mul_(g[..., None]), None, None, None, None, None


def _vocab_parallel_nll(logits, labels, smoothing: float, i: int):
    """The (B, S) loss of the DTensor ``logits`` whose vocab mesh dim ``i``
    alone splits (``constrain.tp_shard_dim``), as a DTensor placed as the
    logits are but whole on mesh dim ``i``: only the (b, S) partials of
    :class:`_VocabParallelNLL` cross its group, no full-vocab tensor is
    made, forward or backward.  ``labels``: the (B, S) DTensor of the
    batch the logits came from."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = logits.device_mesh
    rows = list(logits.placements)
    rows[i] = Replicate()
    if list(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    nll = _VocabParallelNLL.apply(
        logits.to_local(), labels.to_local(),
        constrain_lib.shard_offset(logits, 2),
        logits.shape[-1], smoothing, mesh.get_group(i))
    return DTensor.from_local(nll, mesh, rows, run_check=False)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Mean token NLL in f32. logits (B, S, V), labels (B, S).

    Under activation sharding (``models.constrain``) logits whose vocab
    the tp axis splits are reduced on their shards
    (:func:`_vocab_parallel_nll`): the vocab is never gathered, as the JAX
    package's GSPMD reduction does not gather it.  Where the axes leave
    the vocab whole (a vocab the tp axis does not divide), the gold logit
    is taken with a vocab-local masked sum, as the JAX package takes it;
    the sum of one logit and zeros is that logit, the value ``gather``
    reads."""
    logits = constrain_lib.constrain(logits.to(torch.float32), "dp", None,
                                     "tp")
    tp = constrain_lib.tp_shard_dim(logits, logits.ndim - 1)
    if tp is not None:
        return _vocab_parallel_nll(logits, labels, smoothing, tp).mean()
    logz = torch.logsumexp(logits, dim=-1)
    if constrain_lib.active():
        iota = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(iota == labels.long()[..., None], logits,
                           0.0).sum(dim=-1)
    else:
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if smoothing > 0.0:
        mean_lp = (logits - logz[..., None]).mean(dim=-1)
        nll = (1 - smoothing) * nll - smoothing * mean_lp
    return nll.mean()


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, summed per tensor in
    the JAX package's tree order (``blockopt.leaf_order``)."""
    from repro_torch.core.optim.blockopt import leaf_order
    sums = [tree[k].to(torch.float32).square().sum()
            for k in leaf_order(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most
    ``max_norm``."""
    limit = torch.full_like(norm, max_norm)
    return torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float,
                        out: Optional[Mapping[str, torch.Tensor]] = None):
    """Scale every tensor of ``tree`` so the global norm is at most
    ``max_norm``: **in place**, or into ``out[key]`` for the keys of
    ``out``.  Returns (the scaled tensors by key, norm before clipping).
    The product is taken in f32, as the JAX package's promotes a bf16
    gradient times the f32 scale: a bf16 gradient's clipped value is a new
    f32 tensor, or is written into its ``out`` (the optimizer's f32
    gradient buffer)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    out = out or {}
    clipped = {}
    f32 = torch.float32
    for k, t in tree.items():
        if t.dtype == f32 and (k not in out or out[k].dtype == f32):
            clipped[k] = (torch.mul(t, scale, out=out[k]) if k in out
                          else t.mul_(scale))
        else:
            t = t.to(f32) * scale
            clipped[k] = out[k].copy_(t) if k in out else t
    return clipped, norm


def microbatch_loss(cfg, model: M.Model, hyper: TrainHyper, mb, embeds):
    """(the loss to differentiate, the model's metrics and ce_loss,
    detached) of one microbatch ``mb`` (B, S+1) of tokens: inputs
    [:, :-1], labels [:, 1:], the loss on the token positions only."""
    logits, mx = M.forward(cfg, model, mb[:, :-1], embeds=embeds)
    labels = mb[:, 1:]
    if embeds is not None:
        logits = logits[:, -labels.shape[1]:]  # loss on token positions
    ce = cross_entropy(logits, labels, hyper.label_smoothing)
    total = ce
    if "moe_aux_loss" in mx:
        total = total + hyper.moe_aux_coef * mx["moe_aux_loss"] \
            + hyper.moe_z_coef * mx["moe_z_loss"]
    mx = {k: v.detach() for k, v in mx.items()}
    mx["ce_loss"] = ce.detach()
    return total, mx


def make_train_step(cfg, model: M.Model, optimizer,
                    hyper: TrainHyper = TrainHyper()):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens": (B, S+1) int array} and, for a frontend stub,
    "embeds" (B, frontend_tokens, d); inputs are [:, :-1], labels [:, 1:],
    and the loss is taken on the token positions only.  The loss is the
    cross entropy plus, for MoE models, ``moe_aux_coef * moe_aux_loss +
    moe_z_coef * moe_z_loss``.  ``hyper.microbatches`` splits the batch
    and averages the gradients.  Metrics are 0-d tensors (loss, ce_loss,
    the MoE metrics, grad_norm, the sentinel's sent_* counts, pclip_scale;
    the model's metrics averaged over the microbatches) and floats
    (opt_fused_dispatches, state_bytes_per_param); reading a tensor waits
    for the device."""
    device = next(model.parameters()).device
    params = model.param_dict()
    opt_cfg = getattr(optimizer, "cfg", None)
    sentinel_on = bool(getattr(opt_cfg, "sentinel", False))
    pclip_on = getattr(opt_cfg, "percentile_clipping", 100) < 100
    grad_views = getattr(optimizer, "grad_views", lambda opt_state: {})
    dp = getattr(optimizer, "data_parallel", None)
    shard_grads = bool(getattr(opt_cfg, "shard_grads_active", False))
    buffered = dp is not None or shard_grads

    def microbatches(tokens, embeds):
        n = hyper.microbatches
        parts = [None] * n if embeds is None else embeds.chunk(n, dim=0)
        return list(zip(tokens.chunk(n, dim=0), parts))

    def mean_metrics(mxs: list) -> dict:
        if len(mxs) == 1:
            return mxs[0]
        return {k: torch.stack([m[k] for m in mxs]).mean() for k in mxs[0]}

    def compute_grad_buffer(tokens, embeds, opt_state):
        """Each microbatch's gradients accumulated (and, on a group,
        reduced) into the optimizer's GradBuffer, ``.grad`` dropped after
        each; returns (mean loss, the buffer averaged)."""
        buf = optimizer.init_grad_buffer(opt_state)
        n = hyper.microbatches
        loss_sum = torch.zeros((), device=device)
        mxs = []
        for mb, emb in microbatches(tokens, embeds):
            model.zero_grad(set_to_none=True)
            loss, mx = microbatch_loss(cfg, model, hyper, mb, emb)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            mxs.append(mx)
            optimizer.accumulate_grads(
                buf, {k: p.grad for k, p in params.items()})
        model.zero_grad(set_to_none=True)
        optimizer.finish_grads(buf, n)
        loss, mx = loss_sum / n, mean_metrics(mxs)
        if dp is not None:          # the loss and metrics: mean of the ranks
            for k, v in [("loss", loss), *mx.items()]:
                v = v.clone()
                torch.distributed.all_reduce(v, group=dp[0])
                mx[k] = v / dp[2]
            loss = mx.pop("loss")
        return loss, mx, buf

    def compute_grads(tokens, embeds):
        """(mean loss, metrics, the gradients averaged over the
        microbatches).  Over several microbatches the gradients add up in
        f32, as the JAX package's f32 accumulator does: an f32 parameter's
        in its ``.grad``, another's (bf16) in an f32 tensor of its own."""
        model.zero_grad(set_to_none=True)
        n = hyper.microbatches
        loss_sum = torch.zeros((), device=device)
        mxs, acc = [], {}
        for mb, emb in microbatches(tokens, embeds):
            loss, mx = microbatch_loss(cfg, model, hyper, mb, emb)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            mxs.append(mx)
            if n > 1:
                for k, p in params.items():
                    if p.dtype != torch.float32 and p.grad is not None:
                        acc[k] = (acc[k].add_(p.grad) if k in acc
                                  else p.grad.to(torch.float32))
                        p.grad = None
        grads = {k: acc.get(k, p.grad) for k, p in params.items()}
        if n > 1:
            for g in grads.values():
                g.div_(n)
        return loss_sum / n, mean_metrics(mxs), grads

    def train_step(state: TrainState, batch):
        tokens = torch.as_tensor(batch["tokens"]).to(device, torch.long)
        embeds = batch.get("embeds")
        if embeds is not None:
            embeds = torch.as_tensor(embeds).to(device)
        if dp is not None:              # this rank's rows of the batch
            tokens = tokens.chunk(dp[2], dim=0)[dp[1]]
            if embeds is not None:
                embeds = embeds.chunk(dp[2], dim=0)[dp[1]]
        with tracing.annotate("forward_backward"):
            if not buffered:
                loss, mx, grads = compute_grads(tokens, embeds)
                grads, gnorm = clip_by_global_norm(
                    grads, hyper.grad_clip, grad_views(state.opt_state))
            elif shard_grads:
                loss, mx, grads = compute_grad_buffer(tokens, embeds,
                                                      state.opt_state)
                gnorm = optimizer.grad_buffer_norm(grads)
                optimizer.scale_grads(grads, clip_scale(gnorm,
                                                        hyper.grad_clip))
            else:
                loss, mx, buf = compute_grad_buffer(tokens, embeds,
                                                    state.opt_state)
                grads, gnorm = clip_by_global_norm(
                    optimizer.gather_grads(buf, state.opt_state),
                    hyper.grad_clip)
        lr = hyper.lr_schedule(state.step) if hyper.lr_schedule else None
        dispatch0 = kops.fused_update_count()
        with tracing.annotate("optimizer_update"):
            out = optimizer.apply(grads, state.opt_state, lr=lr)
        new_opt = out[1]
        metrics = {"loss": loss, "grad_norm": gnorm, **mx}
        if sentinel_on:
            health = out[2]
            for i, name in enumerate(kfu.HEALTH_SLOTS):
                metrics[f"sent_{name}"] = health[i]
        metrics["opt_fused_dispatches"] = float(kops.fused_update_count()
                                                - dispatch0)
        sb = optimizer.state_bytes(state.opt_state)
        if sb["n_params"]:
            metrics["state_bytes_per_param"] = (sb["state_bytes"]
                                                / sb["n_params"])
        if "owned_state_bytes" in sb:
            # the partitioned dispatch: the largest owner's block span and
            # its share of the statistics
            metrics["opt_owned_blocks"] = float(sb["owned_blocks"])
            metrics["opt_owned_state_bytes_per_param"] = (
                sb["owned_state_bytes"] / sb["n_params"])
        if shard_grads:
            gbb = optimizer.grad_buffer_bytes(state.opt_state)
            metrics["peak_grad_bytes"] = float(gbb["sharded_grad_bytes"])
            metrics["replicated_grad_bytes"] = float(
                gbb["replicated_grad_bytes"])
        if pclip_on:
            # percentile_clip is pure: against the pre-step state it gives
            # the scale apply used (the old state's history is not mutated)
            metrics["pclip_scale"], _ = optimizer.percentile_clip(
                grads, state.opt_state)
        return TrainState(opt_state=new_opt, step=state.step + 1), metrics

    return train_step


def init_train_state(cfg, optimizer, generator=None, *, device="cuda"
                     ) -> tuple[TrainState, M.Model]:
    """-> (state, model): a model from ``generator`` and its optimizer
    state, whose masters are the model's parameters."""
    model = M.init_model(cfg, generator, device=device)
    opt_state = optimizer.init(model.param_dict())
    return TrainState(opt_state=opt_state, step=0), model


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * lr``; ``sched(step)``
    returns a 0-d f32 CPU tensor (the f32 arithmetic of the JAX package's
    schedule)."""
    def sched(step):
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(torch.pi * frac))
        return torch.where(step < warmup, warm, lr * cos)
    return sched


# ------------------------------------------------------------ contracts
# Registered here, next to the step they protect; evaluated over the
# config matrix by `python -m repro_torch.analysis` (analysis/runner.py),
# each on the recorded trace of one train step.

def _sentinel_invariant(pair, cell):
    """The sentinel's zero-overhead contract: the default and an explicit
    sentinel=False run the identical op sequence, and turning it on keeps
    the same state in place (it only adds the health outputs)."""
    off = {k: t for k, t in pair.items() if k != "on"}
    ok, detail = _contracts.lowering_invariant(off)
    if not ok:
        return False, f"sentinel off not identical: {detail}"
    return _contracts.lowering_invariant(pair, compare_aliases_only=True)


_contracts.register(
    "train_step.donates", "step",
    lambda trace, cell: _contracts.check_donates(trace, "opt_state"),
    doc="the step updates the optimizer state (masters, codes, absmax, "
        "32-bit moments) in place: every piece keeps its storage")
_contracts.register(
    "train_step.no_f64", "step",
    lambda trace, cell: _contracts.check_no_dtype(trace, "f64"),
    doc="no f64 anywhere in the step outside a named exempt scope")
_contracts.register(
    "train_step.collective_order", "step",
    lambda trace, cell: (_contracts.check_collective_order(
        trace, "reduce_scatter", "fused_update_dispatch", "all_gather")
        if getattr(cell, "shard_grads", False)
        and getattr(cell, "world", 1) > 1 else None),
    doc="ZeRO-2 on a process group: the gradients' reduce-scatter, then "
        "the span's fused update, then the masters' all-gather (in one "
        "process the step runs no collective)")
_contracts.register(
    "train_step.telemetry_invariant", "pair:telemetry",
    lambda pair, cell: _contracts.lowering_invariant(pair),
    doc="telemetry_every 0 vs N run the identical op sequence (the probes "
        "run on the host's schedule, outside the step)")
_contracts.register(
    "train_step.overlap_donation_invariant", "pair:overlap",
    lambda pair, cell: _contracts.lowering_invariant(
        pair, compare_aliases_only=True),
    doc="overlap_buckets 1 vs K restructures the launches but keeps the "
        "same state in place")
_contracts.register(
    "train_step.sentinel_invariant", "pair:sentinel", _sentinel_invariant,
    doc="sentinel off runs the identical op sequence; on keeps the same "
        "state in place")
