"""Model assembly: a config compiled into segments of stacked blocks.

A config is compiled into *segments*: maximal runs of a repeating layer
pattern.  Each segment's parameters are stacked on a leading repeat axis,
as in the JAX package, so parameters map one to one; the port loops over
the repeats where the JAX package scans.

The port runs attention + dense-FFN blocks (the dense GQA families:
deepseek-7b, chatglm3, deepseek-coder, nemotron, internvl2's language
model), Mamba2 blocks (mamba2-130m) and MoE FFN blocks on one device
(olmoe-1b-7b; with the other two, jamba-v0.1-52b).  MLA attention and the
encoder raise ``NotImplementedError`` naming the ROADMAP item that ports
them.

The Model exposes:
- ``init(generator)``               → fills the parameters, returns self
- ``loss(batch)``                   → (scalar loss, metrics) for train_step
- ``forward(batch)``                → logits (prefill)
- ``init_cache(batch, max_len)``    → decode cache (nested lists of dicts)
- ``decode_step(caches, tokens, index)`` → (logits, caches)
"""
from __future__ import annotations

import dataclasses
import math

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


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder and cross-attention blocks are not ported "
            "yet (ROADMAP Queue 1, remaining families: whisper)")
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP Queue 1, "
            "MLA and MTP)")


# RunConfig fields the port reads; the others name the ROADMAP item
# (Queue 1) that would implement them
_READ = ("attn_impl", "ssm_chunk", "remat", "microbatches", "logits_fp32")
_UNREAD = {"opt_8bit": "item 4, optimizer and compression extras",
           "grad_compression": "item 4, optimizer and compression extras"}


def _check_run(run: RunConfig) -> None:
    """Any field the port does not read, set away from its default, raises
    rather than be ignored without a word.  ``sync_mode`` stays
    ``"barrier"``: on one card there is no gradient collective to order."""
    unread = {f.name: _UNREAD.get(f.name, "item 5, multi-GPU sync")
              for f in dataclasses.fields(run)
              if f.name not in _READ and getattr(run, f.name) != f.default}
    if unread:
        raise NotImplementedError(
            f"RunConfig fields are not implemented by the port yet "
            f"(ROADMAP Queue 1): {unread}")


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
class _Block(nn.Module):
    """One pattern position of a segment, every tensor stacked [R, ...].

    Parameter names follow the JAX pytree (``ln1``, ``attn.wq``, ...), so
    ``named_parameters`` maps onto the checkpoint keys."""

    def __init__(self, spec: BlockSpec, cfg: ArchConfig, repeats: int,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg

        def empty(*shape, dtype=dtype):
            return nn.Parameter(torch.empty((repeats,) + shape, dtype=dtype,
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
            self.attn = stacked(attn.gqa_shapes(cfg))
        else:
            self.ssm = with_fp32(ssm.ssm_shapes(cfg), ssm.FP32_PARAMS)
        if spec.ffn == "dense":
            self.ln2 = empty(cfg.d_model)
            self.mlp = stacked(mlp_shapes(cfg.d_model, cfg.d_ff,
                                          cfg.mlp_type))
        elif spec.ffn == "moe":
            self.ln2 = empty(cfg.d_model)
            self.moe = with_fp32(moe.moe_shapes(cfg), moe.FP32_PARAMS)

    def init_repeat(self, generator: torch.Generator, r: int) -> None:
        """Draw repeat r's parameters as the JAX block init does."""
        cfg, p = self.cfg, self.ln1
        self.ln1[r].fill_(1.0)
        if hasattr(self, "attn"):
            mixer, init = self.attn, attn.gqa_init
        else:
            mixer, init = self.ssm, ssm.ssm_init
        for name, w in init(generator, cfg, dtype=p.dtype,
                            device=p.device).items():
            mixer[name][r].copy_(w)
        if hasattr(self, "mlp"):
            self.ln2[r].fill_(1.0)
            for name, w in mlp_init(generator, cfg.d_model, cfg.d_ff,
                                    cfg.mlp_type, dtype=p.dtype,
                                    device=p.device).items():
                self.mlp[name][r].copy_(w)
        if hasattr(self, "moe"):
            self.ln2[r].fill_(1.0)
            for name, w in moe.moe_init(generator, cfg, dtype=p.dtype,
                                        device=p.device).items():
                self.moe[name][r].copy_(w)

    def at(self, r: int) -> dict:
        """Repeat r's parameters as the nested dict the layer functions take."""
        out = {}
        for name, child in self.named_children():
            out[name] = {k: v[r] for k, v in child.items()}
        for name, param in self.named_parameters(recurse=False):
            out[name] = param[r]
        return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, run: RunConfig = RunConfig(), *,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.run = run
        self.dtype = dtype
        self.segments_spec = derive_segments(cfg)
        _check_supported(cfg)
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
        return self

    # ------------------------------------------------------------------
    def _apply_block(self, bp: dict, spec: BlockSpec, x, *,
                     positions=None, cache=None, cache_index=None):
        """One block: (x, the block's MoE aux loss, or None)."""
        cfg, run = self.cfg, self.run
        aux = None
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        if spec.mixer == "attn":
            out, _ = attn.gqa_apply(
                bp["attn"], h, cfg, positions=positions,
                cache=cache.get("attn") if cache else None,
                cache_index=cache_index, causal=spec.causal,
                impl=run.attn_impl)
        else:
            out, _ = ssm.ssm_apply(bp["ssm"], h, cfg,
                                   cache=cache.get("ssm") if cache else None,
                                   chunk=run.ssm_chunk or None)
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
                    caches=None, cache_index=None):
        """Repeat r of segment si: each of its pattern's blocks in turn.
        Returns (x, the MoE blocks' summed aux loss, or None)."""
        total_aux = None
        for j, spec in enumerate(self.segments_spec[si].pattern):
            cache = None
            if caches is not None:
                cache = {name: {k: v[r] for k, v in c.items()}
                         for name, c in caches[si][j].items()}
            x, aux = self._apply_block(
                self.segments[si][j].at(r), spec, x, positions=positions,
                cache=cache, cache_index=cache_index)
            if aux is not None:
                total_aux = aux if total_aux is None else total_aux + aux
        return x, total_aux

    def _run_segments(self, x, *, positions=None, caches=None,
                      cache_index=None):
        """Loop each segment over its repeats.  Returns (x, the MoE blocks'
        summed aux loss: a 0-d fp32 tensor, or 0.0 without MoE blocks).
        Caches are written in place.  With ``run.remat`` and autograd
        recording, each repeat runs under ``torch.utils.checkpoint``, as
        JAX's ``jax.checkpoint`` wraps the scan body: its activations are
        recomputed in the backward."""
        remat = (self.run.remat and caches is None
                 and torch.is_grad_enabled())
        kw = dict(positions=positions, caches=caches, cache_index=cache_index)
        total_aux = 0.0
        for si, seg in enumerate(self.segments_spec):
            for r in range(seg.repeats):
                if remat:
                    x, aux = torch.utils.checkpoint.checkpoint(
                        self._run_repeat, si, r, x, use_reentrant=False,
                        **kw)
                else:
                    x, aux = self._run_repeat(si, r, x, **kw)
                if aux is not None:
                    total_aux = total_aux + aux
        return x, total_aux

    # ------------------------------------------------------------------
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
        x, _ = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_segments(x, positions=positions)
        return self._head(x)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE over the text region (after any vision prefix),
        plus ``router_aux_weight`` × the MoE blocks' aux loss.  Returns
        (loss, {"ce", "aux", "loss"}), 0-d fp32 tensors."""
        cfg = self.cfg
        if cfg.mtp:
            raise NotImplementedError(
                f"{cfg.name}: the multi-token-prediction head is not ported "
                "yet (ROADMAP Queue 1 item 2, MLA and MTP)")
        x, n_prefix = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._run_segments(x, positions=positions)
        tokens = batch["tokens"]
        h = x[:, n_prefix:]                       # text region only
        logits = self._head(h[:, :-1])
        if self.run.logits_fp32:
            logits = logits.float()
        ce = cross_entropy(logits, tokens[:, 1:])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> list:
        """caches[segment][pattern position] = {"attn": {"k", "v"}}, each
        [R, B, max_len, K, hd] in the model dtype, or {"ssm": {"conv",
        "state"}}: [R, B, W-1, conv_dim] in the model dtype and [R, B, H,
        P, N] in fp32 (an SSM cache does not grow with max_len)."""
        caches = []
        kw = dict(dtype=self.dtype, device=self.device)
        for seg in self.segments_spec:
            seg_caches = []
            for spec in seg.pattern:
                if spec.mixer == "attn":
                    name, one = "attn", attn.gqa_cache_init(
                        self.cfg, batch_size, max_len, **kw)
                else:
                    name, one = "ssm", ssm.ssm_cache_init(
                        self.cfg, batch_size, **kw)
                seg_caches.append({name: {
                    k: torch.zeros((seg.repeats,) + v.shape, dtype=v.dtype,
                                   device=v.device)
                    for k, v in one.items()}})
            caches.append(seg_caches)
        return caches

    def decode_step(self, caches, tokens: torch.Tensor, index: int):
        """tokens: [B,S] written at cache rows index..index+S (a Python int).

        S is 1 for a decode step; at index 0 a whole prompt prefills in one
        call.  Attention blocks run it through K1 on the "kernel" path; SSM
        blocks run the chunked scan through K2 from the cache's state (S a
        multiple of the chunk, or shorter than it) and leave the final
        state and conv tail in the cache, for any index.  MoE blocks run
        their experts on K3 with a capacity computed from the B·S tokens of
        the call, as JAX's ``forward`` over the same tokens does: where an
        expert overflows, a one-call prefill drops assignments that JAX's
        token-by-token decode (B tokens a call) keeps."""
        x = self.embed[tokens].to(self.dtype)
        x, _ = self._run_segments(x, caches=caches, cache_index=index)
        return self._head(x), caches
