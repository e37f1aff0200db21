"""Model assembly: a config compiled into segments of stacked blocks.

A config is compiled into *segments*: maximal runs of a repeating layer
pattern.  Each segment's parameters are stacked on a leading repeat axis,
as in the JAX package, so parameters map one to one; the port loops over
the repeats where the JAX package scans.

Every architecture of the configs builds: attention + dense-FFN blocks
(deepseek-7b, chatglm3, deepseek-coder, nemotron, internvl2's language
model), Mamba2 blocks (mamba2-130m), MoE FFN blocks on one device
(olmoe-1b-7b, jamba-v0.1-52b), MLA attention after a first-dense split with
the multi-token-prediction head (deepseek-v3), and an encoder whose
states the decoder blocks cross-attend to (whisper).

The Model exposes:
- ``init(generator)``               → fills the parameters, returns self
- ``loss(batch)``                   → (scalar loss, metrics) for train_step
- ``forward(batch)``                → logits (prefill)
- ``encode(batch)``                 → encoder states (whisper)
- ``init_cache(batch, max_len)``    → decode cache (nested lists of dicts)
- ``decode_step(caches, tokens, index, enc_out=None)`` → (logits, caches)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.layers import (
    cross_entropy, dense_init, embed_init, mlp, mlp_init, mlp_shapes,
    rmsnorm,
)


# ----------------------------------------------------------------------
# segment derivation (same as the JAX package's)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str           # "attn" | "mamba"
    ffn: str             # "dense" | "moe" | "none"
    causal: bool = True
    cross: bool = False  # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple[BlockSpec, ...]
    repeats: int


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def derive_segments(cfg: ArchConfig, *, cross: bool = False,
                    causal: bool = True) -> list[Segment]:
    def spec(i: int) -> BlockSpec:
        mixer = cfg.pattern[i % len(cfg.pattern)]
        if cfg.is_moe_layer(i):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        if mixer == "mamba":
            ffn = ffn if cfg.family == "hybrid" else \
                ("none" if cfg.d_ff == 0 else ffn)
        return BlockSpec(mixer=mixer, ffn=ffn, causal=causal, cross=cross)

    regions = []
    if cfg.first_dense_layers:
        regions.append((0, cfg.first_dense_layers))
        regions.append((cfg.first_dense_layers, cfg.n_layers))
    else:
        regions.append((0, cfg.n_layers))

    segments = []
    for (lo, hi) in regions:
        n = hi - lo
        if n <= 0:
            continue
        period = _lcm(len(cfg.pattern),
                      cfg.moe_layer_period if cfg.n_experts else 1)
        if n % period != 0:
            period = n
        pat = tuple(spec(lo + j) for j in range(period))
        segments.append(Segment(pattern=pat, repeats=n // period))
    return segments


# RunConfig fields the port reads (``opt_8bit`` and ``grad_compression``
# in ``launch.train``).  The others (``fsdp``, ``batch_axes``,
# ``moe_combine``, ``seq_shard``) steer the JAX package's GSPMD sharding of
# one logical program over a mesh, which the port, one process a card
# with data parallelism by ``torch.distributed``, has no counterpart of
_READ = ("attn_impl", "ssm_chunk", "remat", "microbatches", "logits_fp32",
         "opt_8bit", "grad_compression", "sync_mode")
SYNC_MODES = ("barrier", "bucketed")


def _check_run(run: RunConfig) -> None:
    """Any field the port does not read, set away from its default, raises
    rather than be ignored without a word."""
    if run.sync_mode not in SYNC_MODES:
        raise ValueError(f"sync_mode {run.sync_mode!r}: want one of "
                         f"{SYNC_MODES}")
    unread = [f.name for f in dataclasses.fields(run)
              if f.name not in _READ and getattr(run, f.name) != f.default]
    if unread:
        raise NotImplementedError(
            f"RunConfig fields {unread} steer the JAX package's GSPMD "
            f"sharding, which the port does not have")


def _leaves(tree: dict) -> list:
    """The tensors of a nested dict, in order."""
    return [t for v in tree.values()
            for t in (_leaves(v) if isinstance(v, dict) else [v])]


def _rebuild(tree: dict, leaves) -> dict:
    """``tree`` with its tensors replaced, in order, from ``leaves``."""
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
class _Block(nn.Module):
    """One pattern position of a segment, every tensor stacked [R, ...];
    with ``repeats=None`` one block, unstacked (the MTP block).

    Parameter names follow the JAX pytree (``ln1``, ``attn.wq``, ...), so
    ``named_parameters`` maps onto the checkpoint keys."""

    def __init__(self, spec: BlockSpec, cfg: ArchConfig,
                 repeats: Optional[int], dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        lead = () if repeats is None else (repeats,)

        def empty(*shape, dtype=dtype):
            return nn.Parameter(torch.empty(lead + shape, dtype=dtype,
                                            device=device))

        def stacked(shapes):
            return nn.ParameterDict({name: empty(*shape)
                                     for name, (shape, _) in shapes.items()})

        def with_fp32(shapes, fp32):
            return nn.ParameterDict({
                name: empty(*shape, dtype=torch.float32
                            if name in fp32 else dtype)
                for name, shape in shapes.items()})

        self.ln1 = empty(cfg.d_model)
        if spec.mixer == "attn":
            self.attn = stacked(attn.mla_shapes(cfg)
                                if cfg.attn_type == "mla"
                                else attn.gqa_shapes(cfg))
        else:
            self.ssm = with_fp32(ssm.ssm_shapes(cfg), ssm.FP32_PARAMS)
        if spec.cross:
            self.ln_x = empty(cfg.d_model)
            self.xattn = stacked(attn.gqa_shapes(cfg))
        if spec.ffn == "dense":
            self.ln2 = empty(cfg.d_model)
            self.mlp = stacked(mlp_shapes(cfg.d_model, cfg.d_ff,
                                          cfg.mlp_type))
        elif spec.ffn == "moe":
            self.ln2 = empty(cfg.d_model)
            self.moe = with_fp32(moe.moe_shapes(cfg), moe.FP32_PARAMS)

    def init_repeat(self, generator: torch.Generator,
                    r: Optional[int]) -> None:
        """Draw repeat r's parameters (all of an unstacked block's: r None)
        as the JAX block init does.  Each MoE tensor is drawn in fp32 and
        copied (cast) into its stack before the next is drawn, so init
        holds one fp32 draw beside the parameters."""
        cfg, p = self.cfg, self.ln1
        kw = dict(dtype=p.dtype, device=p.device)

        def rows(t):
            return t if r is None else t[r]

        def fill(params, draws):
            for name, w in draws:
                rows(params[name]).copy_(w)
                del w               # freed before the next draw

        rows(self.ln1).fill_(1.0)
        if hasattr(self, "attn"):
            init = attn.mla_init if cfg.attn_type == "mla" else attn.gqa_init
            fill(self.attn, init(generator, cfg, **kw).items())
        else:
            fill(self.ssm, ssm.ssm_init(generator, cfg, **kw).items())
        if hasattr(self, "xattn"):
            rows(self.ln_x).fill_(1.0)
            fill(self.xattn, attn.gqa_init(generator, cfg, **kw).items())
        if hasattr(self, "mlp"):
            rows(self.ln2).fill_(1.0)
            fill(self.mlp, mlp_init(generator, cfg.d_model, cfg.d_ff,
                                    cfg.mlp_type, **kw).items())
        if hasattr(self, "moe"):
            rows(self.ln2).fill_(1.0)
            fill(self.moe, moe.moe_draws(generator, cfg, device=p.device))

    def stacked(self) -> dict:
        """The parameters, stacked, as the nested dict the layer functions
        take (``attn`` → {``wq``, ...}, ``ln1``, ...)."""
        out = {name: dict(child.items())
               for name, child in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out

    def at(self, r: Optional[int]) -> dict:
        """Repeat r's parameters (an unstacked block's: r None) as the
        nested dict the layer functions take."""
        tree = self.stacked()
        if r is None:
            return tree
        return _rebuild(tree, (t[r] for t in _leaves(tree)))


class _Mtp(nn.Module):
    """The multi-token-prediction head's parameters, unstacked as in JAX:
    ``proj`` [2d, d], one attention + dense-FFN ``block`` and ``ln``."""

    SPEC = BlockSpec("attn", "dense")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d = cfg.d_model
        self.proj = nn.Parameter(torch.empty((2 * d, d), dtype=dtype,
                                             device=device))
        self.block = _Block(self.SPEC, cfg, None, dtype, device)
        self.ln = nn.Parameter(torch.empty((d,), dtype=dtype, device=device))

    def init(self, generator: torch.Generator) -> None:
        d = self.ln.shape[0]
        self.proj.copy_(dense_init(generator, 2 * d, d, dtype=self.ln.dtype,
                                   device=self.ln.device))
        self.block.init_repeat(generator, None)
        self.ln.fill_(1.0)


class Model(nn.Module):
    # whisper's encoder: non-causal self-attention (with RoPE, as in JAX)
    # and a dense FFN, stacked under ``encoder``
    ENC_SPEC = BlockSpec("attn", "dense", causal=False)

    def __init__(self, cfg: ArchConfig, run: RunConfig = RunConfig(), *,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.run = run
        self.dtype = dtype
        self.segments_spec = derive_segments(cfg)
        if cfg.encoder_layers:
            # decoder blocks cross-attend to the encoder's states
            self.segments_spec = [
                Segment(tuple(dataclasses.replace(s, cross=True)
                              for s in seg.pattern), seg.repeats)
                for seg in self.segments_spec]
        _check_run(run)
        dev = _device.resolve(device)
        d, V = cfg.d_model, cfg.vocab_size

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        self.embed = empty(V, d)
        self.final_norm = empty(d)
        if not cfg.tie_embeddings:
            self.lm_head = empty(d, V)
        if cfg.vision_embed_dim:
            self.vis_proj = empty(cfg.vision_embed_dim, d)
        self.segments = nn.ModuleList(
            nn.ModuleList(_Block(spec, cfg, seg.repeats, dtype, dev)
                          for spec in seg.pattern)
            for seg in self.segments_spec)
        if cfg.encoder_layers:
            self.encoder = _Block(self.ENC_SPEC, cfg, cfg.encoder_layers,
                                  dtype, dev)
            self.enc_norm = empty(d)
        if cfg.mtp:
            self.mtp = _Mtp(cfg, dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter as the JAX init does: norms with ones, the
        rest fp32 normal × scale cast to the model dtype, one repeat of a
        stacked block at a time (to bound the fp32 temporaries)."""
        cfg, kw = self.cfg, dict(dtype=self.dtype, device=self.device)
        self.embed.copy_(embed_init(generator, cfg.vocab_size, cfg.d_model,
                                    **kw))
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            self.lm_head.copy_(dense_init(generator, cfg.d_model,
                                          cfg.vocab_size, **kw))
        if cfg.vision_embed_dim:
            self.vis_proj.copy_(dense_init(generator, cfg.vision_embed_dim,
                                           cfg.d_model, **kw))
        for seg, blocks in zip(self.segments_spec, self.segments):
            for r in range(seg.repeats):
                for block in blocks:
                    block.init_repeat(generator, r)
        if cfg.encoder_layers:
            for r in range(cfg.encoder_layers):
                self.encoder.init_repeat(generator, r)
            self.enc_norm.fill_(1.0)
        if cfg.mtp:
            self.mtp.init(generator)
        return self

    # ------------------------------------------------------------------
    def _apply_block(self, bp: dict, spec: BlockSpec, x, *,
                     positions=None, cache=None, cache_index=None,
                     enc_out=None):
        """One block: (x, the block's MoE aux loss, or None)."""
        cfg, run = self.cfg, self.run
        aux = None
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        if spec.mixer == "attn":
            c = cache.get("attn") if cache else None
            if cfg.attn_type == "mla":
                out, _ = attn.mla_apply(bp["attn"], h, cfg,
                                        positions=positions, cache=c,
                                        cache_index=cache_index,
                                        impl=run.attn_impl)
            else:
                out, _ = attn.gqa_apply(bp["attn"], h, cfg,
                                        positions=positions, cache=c,
                                        cache_index=cache_index,
                                        causal=spec.causal,
                                        impl=run.attn_impl)
        else:
            out, _ = ssm.ssm_apply(bp["ssm"], h, cfg,
                                   cache=cache.get("ssm") if cache else None,
                                   chunk=run.ssm_chunk or None)
        x = x + out
        if spec.cross and enc_out is not None:
            h = rmsnorm(bp["ln_x"], x, cfg.norm_eps)
            out, _ = attn.gqa_apply(bp["xattn"], h, cfg, kv_src=enc_out,
                                    impl=run.attn_impl)
            x = x + out
        if spec.ffn == "dense":
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            x = x + mlp(bp["mlp"], h, cfg.mlp_type)
        elif spec.ffn == "moe":
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            y, aux = moe.moe_apply(bp["moe"], h, cfg)
            x = x + y
        return x, aux

    def _run_repeat(self, si: int, r: int, x, *, positions=None,
                    caches=None, cache_index=None, enc_out=None, sync=None):
        """Repeat r of segment si: each of its pattern's blocks in turn,
        on their parameters' rows r (under a ``GradSync``, through its
        bucket, so their gradients are reduced when this repeat's backward
        is done).  Returns (x, the MoE blocks' summed aux loss, or None)."""
        trees = [block.stacked() for block in self.segments[si]]
        stacks = [t for tree in trees for t in _leaves(tree)]
        rows = iter(sync.bucket((si, r), stacks, r) if sync is not None
                    else [t[r] for t in stacks])
        bps = [_rebuild(tree, rows) for tree in trees]
        total_aux = None
        for j, spec in enumerate(self.segments_spec[si].pattern):
            cache = None
            if caches is not None:
                cache = {name: {k: v[r] for k, v in c.items()}
                         for name, c in caches[si][j].items()}
            x, aux = self._apply_block(
                bps[j], spec, x, positions=positions,
                cache=cache, cache_index=cache_index, enc_out=enc_out)
            if aux is not None:
                total_aux = aux if total_aux is None else total_aux + aux
        return x, total_aux

    def _run_segments(self, x, *, positions=None, caches=None,
                      cache_index=None, enc_out=None, sync=None):
        """Loop each segment over its repeats.  Returns (x, the MoE blocks'
        summed aux loss: a 0-d fp32 tensor, or 0.0 without MoE blocks).
        Caches are written in place.  With ``run.remat`` and autograd
        recording, each repeat runs under ``torch.utils.checkpoint``, as
        JAX's ``jax.checkpoint`` wraps the scan body: its activations are
        recomputed in the backward.

        With ``run.sync_mode == "bucketed"``, a ``sync``
        (``sync.overlap.GradSync``) and autograd recording, each repeat's
        parameter gradients are reduced across the data-parallel ranks
        inside the backward, as soon as that repeat's backward is done
        (the JAX package's synced scan); otherwise ``sync.finish`` reduces
        them after the backward."""
        remat = (self.run.remat and caches is None
                 and torch.is_grad_enabled())
        if not (self.run.sync_mode == "bucketed" and caches is None
                and torch.is_grad_enabled()):
            sync = None
        kw = dict(positions=positions, caches=caches, cache_index=cache_index,
                  enc_out=enc_out, sync=sync)
        total_aux = 0.0
        for si, seg in enumerate(self.segments_spec):
            for r in range(seg.repeats):
                if remat:
                    x, aux = torch.utils.checkpoint.checkpoint(
                        self._run_repeat, si, r, x, use_reentrant=False,
                        **kw)
                else:
                    x, aux = self._run_repeat(si, r, x, **kw)
                if sync is not None:
                    sync.mark(x, (si, r))
                if aux is not None:
                    total_aux = total_aux + aux
        return x, total_aux

    # ------------------------------------------------------------------
    def _encode_layer(self, r: int, x):
        return self._apply_block(self.encoder.at(r), self.ENC_SPEC, x)[0]

    def encode(self, batch: dict) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings
        ``batch["audio_embeds"]`` [B, frames, d] (the conv front end is a
        stub, as in the JAX package); each layer under
        ``torch.utils.checkpoint`` where ``_run_segments`` would use it."""
        x = batch["audio_embeds"].to(self.dtype)
        remat = self.run.remat and torch.is_grad_enabled()
        for r in range(self.cfg.encoder_layers):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._encode_layer, r, x, use_reentrant=False)
            else:
                x = self._encode_layer(r, x)
        return rmsnorm(self.enc_norm, x, self.cfg.norm_eps)

    def _embed_inputs(self, batch: dict):
        """Token embedding, after the projected vision prefix if any.
        Returns (x, the prefix's length)."""
        x = self.embed[batch["tokens"]].to(self.dtype)
        n_prefix = 0
        if self.cfg.vision_embed_dim and "vision_embeds" in batch:
            v = batch["vision_embeds"].to(self.dtype) @ self.vis_proj
            x = torch.cat([v, x], dim=1)
            n_prefix = v.shape[1]
        return x, n_prefix

    def _head(self, x):
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.lm_head

    # ------------------------------------------------------------------
    def forward(self, batch: dict) -> torch.Tensor:
        enc_out = self.encode(batch) if self.cfg.encoder_layers else None
        x, _ = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_segments(x, positions=positions, enc_out=enc_out)
        return self._head(x)

    def loss(self, batch: dict, sync=None) -> tuple[torch.Tensor, dict]:
        """Next-token CE over the text region (after any vision prefix),
        plus ``router_aux_weight`` × the MoE blocks' aux loss, plus 0.3 ×
        the MTP head's CE where the config has one.  Returns (loss, {"ce",
        "aux", "loss"} and "mtp_ce" with MTP), 0-d fp32 tensors.  ``sync``
        (a ``sync.overlap.GradSync``) is the backward's gradient sync, which
        ``_run_segments`` wires in bucketed mode."""
        cfg = self.cfg
        enc_out = self.encode(batch) if cfg.encoder_layers else None
        x, n_prefix = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._run_segments(x, positions=positions, enc_out=enc_out,
                                    sync=sync)
        tokens = batch["tokens"]
        h = x[:, n_prefix:]                       # text region only
        logits = self._head(h[:, :-1])
        if self.run.logits_fp32:
            logits = logits.float()
        ce = cross_entropy(logits, tokens[:, 1:])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + cfg.router_aux_weight * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.mtp:
            # predict t+2 from [h_t ; emb(t+1)] through one more block; its
            # aux loss is dropped and its logits are fp32, as in JAX
            mtp = self.mtp
            h_in = rmsnorm(mtp.ln, h[:, :-1], cfg.norm_eps)
            nxt = self.embed[tokens[:, 1:]].to(self.dtype)
            z = torch.cat([h_in, nxt], dim=-1) @ mtp.proj
            z, _ = self._apply_block(mtp.block.at(None), mtp.SPEC, z,
                                     positions=positions[:z.shape[1]])
            mtp_ce = cross_entropy(self._head(z[:, :-1]).float(),
                                   tokens[:, 2:])
            loss = loss + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> list:
        """caches[segment][pattern position] = {"attn": {"k", "v"}}, each
        [R, B, max_len, K, hd] in the model dtype (MLA: {"ckv", "kr"},
        [R, B, max_len, kv_lora] and [R, B, max_len, rope_d]), or {"ssm":
        {"conv", "state"}}: [R, B, W-1, conv_dim] in the model dtype and
        [R, B, H, P, N] in fp32 (an SSM cache does not grow with
        max_len)."""
        caches = []
        kw = dict(dtype=self.dtype, device=self.device)
        for seg in self.segments_spec:
            seg_caches = []
            for spec in seg.pattern:
                if spec.mixer == "attn":
                    init = (attn.mla_cache_init
                            if self.cfg.attn_type == "mla"
                            else attn.gqa_cache_init)
                    name, one = "attn", init(self.cfg, batch_size, max_len,
                                             **kw)
                else:
                    name, one = "ssm", ssm.ssm_cache_init(
                        self.cfg, batch_size, **kw)
                seg_caches.append({name: {
                    k: torch.zeros((seg.repeats,) + v.shape, dtype=v.dtype,
                                   device=v.device)
                    for k, v in one.items()}})
            caches.append(seg_caches)
        return caches

    def decode_step(self, caches, tokens: torch.Tensor, index: int, *,
                    enc_out: Optional[torch.Tensor] = None):
        """tokens: [B,S] written at cache rows index..index+S (a Python int).
        ``enc_out`` (``encode``'s output) feeds every cross-attention block,
        recomputing its K/V at each call, as the JAX package does.

        S is 1 for a decode step; at index 0 a whole prompt prefills in one
        call.  Attention blocks run it through K1 on the "kernel" path; SSM
        blocks run the chunked scan through K2 from the cache's state (S a
        multiple of the chunk, or shorter than it) and leave the final
        state and conv tail in the cache, for any index.  MoE blocks run
        their experts on K3 with a capacity computed from the B·S tokens of
        the call, as JAX's ``forward`` over the same tokens does: where an
        expert overflows, a one-call prefill drops assignments that JAX's
        token-by-token decode (B tokens a call) keeps.  MLA blocks prefill
        at index 0 through K1 on the expanded latents and decode in the
        latent space.  An encoder-decoder model needs ``enc_out``: without
        it the cross-attention blocks would be skipped."""
        if self.cfg.encoder_layers and enc_out is None:
            raise ValueError(f"{self.cfg.name} has an encoder: decode_step "
                             f"needs its enc_out (Model.encode)")
        x = self.embed[tokens].to(self.dtype)
        x, _ = self._run_segments(x, caches=caches, cache_index=index,
                                  enc_out=enc_out)
        return self._head(x), caches
