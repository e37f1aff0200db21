"""The port on the card: K1, K2 and K3 built from source and held against
their plain versions (forward, and the gradients of their recompute
backwards), the serving paths counting their launches, and the loss's
gradients on the card against CPU copies.

Run on a machine with a CUDA device (it imports no JAX):

    python -m pytest -m gpu tests/test_torch_gpu.py -q

Without a card every test here skips; with one, a missing ``nvcc`` fails.
The deepseek-v3 K3 shapes hold 7.5 GB of weights a case.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.launch import serve
from repro_torch.models import Model, moe

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),   # tests/test_kernels.py:15
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# K2 against its plain version: tests/test_kernels.py:95 (fp32 1e-4: the
# products are summed in another order, and y and the state reach ~1e2)
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, S, H, K, hd, hdv, dtype, device):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device, dtype)
                 for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hdv)))


@pytest.mark.parametrize("B,S,H,K,hd,hdv,causal,dtype", [
    (2, 256, 4, 4, 128, 128, True, torch.bfloat16),
    (2, 300, 8, 2, 64, 64, True, torch.bfloat16),     # GQA 4:1, ragged S
    (1, 130, 4, 1, 16, 16, False, torch.bfloat16),    # MQA, hd 16
    (1, 96, 2, 2, 192, 128, True, torch.bfloat16),    # hd != hd_v
    (2, 200, 4, 2, 128, 128, True, torch.float32),
    # the tensor-core tilings' edges: S one under and over a 64-row tile,
    # hd that pads to the MMA's k, hd_v 256, MLA's 192/128 at S 1024, GQA
    # 4:1 at the serving shape
    (2, 127, 4, 4, 128, 128, True, torch.bfloat16),
    (2, 129, 4, 2, 128, 128, True, torch.bfloat16),
    (2, 129, 4, 4, 64, 64, False, torch.bfloat16),
    (2, 200, 4, 2, 8, 8, True, torch.bfloat16),
    (2, 200, 4, 4, 40, 40, True, torch.bfloat16),
    (2, 300, 4, 2, 256, 256, True, torch.bfloat16),
    (1, 200, 4, 4, 64, 256, False, torch.bfloat16),
    (1, 1024, 16, 16, 192, 128, True, torch.bfloat16),
    (4, 1024, 32, 8, 128, 128, True, torch.bfloat16),
    (4, 2048, 16, 8, 128, 128, True, torch.bfloat16),   # internvl2 training
    (4, 2048, 16, 16, 128, 128, True, torch.bfloat16),  # olmoe training
    (4, 1024, 128, 128, 192, 128, True, torch.bfloat16),  # deepseek-v3 MLA
    (4, 1500, 20, 20, 64, 64, False, torch.bfloat16),   # whisper encoder
    (4, 128, 20, 20, 64, 64, True, torch.bfloat16),     # whisper decoder
])
def test_kernel_matches_plain(cuda, B, S, H, K, hd, hdv, causal, dtype):
    q, k, v = _inputs(B, S, H, K, hd, hdv, dtype, cuda)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               **TOL[dtype])


def test_kernel_takes_grad(cuda):
    """A CUDA input that requires grad runs K1 (counted) and has a
    gradient: the recompute backward through the plain version."""
    q = torch.randn((1, 64, 2, 16), device=cuda, requires_grad=True)
    before = ops.flash_attention.launches
    o = ops.flash_attention(q, q.detach(), q.detach())
    assert ops.flash_attention.launches == before + 1
    (g,) = torch.autograd.grad(o.sum(), q)
    assert g.shape == q.shape and torch.isfinite(g).all()


def _grad_inputs(kernel, shape, dtype, device):
    rng = np.random.default_rng(7)

    def randn(*sh, dt=dtype):
        return torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)
                                ).to(device, dt)
    if kernel == "K1":
        B, S, H, K, hd = shape
        ins = [randn(B, S, H, hd), randn(B, S, K, hd), randn(B, S, K, hd)]
        return (ins, ops.flash_attention,
                lambda *t: (ops.flash_attention(*t, causal=True),),
                ops._plain_attention(True, None))
    if kernel == "K2":
        B, L, H, G, P, N, Q = shape
        ins = [randn(B, L, H, P),
               torch.nn.functional.softplus(randn(B, L, H, dt=torch.float32)),
               -torch.linspace(1.0, 16.0, H, device=device),
               randn(B, L, G, N), randn(B, L, G, N)]
        return (ins, ops.ssd_chunked,
                lambda *t: ops._SsdIntraChunk.apply(*t, Q),
                ops._plain_intra_chunk(Q))
    E, C, d, f = shape
    return ([randn(E, C, d), randn(E, d, f)], ops.grouped_matmul,
            lambda *t: (ops.grouped_matmul(*t),),
            lambda x, w: (ref.gmm_ref(x, w),))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel,shape", [
    ("K1", (2, 128, 4, 2, 64)), ("K1", (1, 200, 4, 4, 128)),
    ("K1", (4, 2048, 16, 8, 128)),              # internvl2-2b training
    ("K1", (4, 2048, 16, 16, 128)),             # olmoe-1b-7b training
    ("K2", (2, 64, 8, 1, 16, 16, 8)), ("K2", (1, 512, 4, 2, 64, 128, 256)),
    ("K2", (8, 4096, 24, 1, 64, 128, 256)),     # mamba2-130m training
    ("K3", (4, 64, 128, 64)), ("K3", (8, 72, 256, 128)),
    ("K3", (64, 1280, 2048, 1024)),             # olmoe-1b-7b training
])
def test_kernel_gradients_match_plain(cuda, kernel, shape, dtype):
    """Each kernel through its autograd.Function (forward on the kernel,
    one launch counted; backward recomputing the plain version) against
    autograd through the plain version on the card: the forward, and the
    gradient of every input, within tests/test_kernels.py:15's tolerance
    with its absolute part scaled by max|want| (as chip_smoke.py's
    gradient phase)."""
    ins, wrapper, kern, plain = _grad_inputs(kernel, shape, dtype, cuda)
    ins = [t.requires_grad_() for t in ins]
    before = wrapper.launches
    got = kern(*ins)
    assert wrapper.launches == before + 1
    want = plain(*ins)
    rng = np.random.default_rng(8)
    cots = [torch.from_numpy(rng.standard_normal(tuple(w.shape),
                                                 dtype=np.float32))
            .to(cuda, w.dtype) for w in want]
    pairs = list(zip(got, want)) + list(zip(
        torch.autograd.grad(got, ins, cots),
        torch.autograd.grad(want, ins, cots)))
    tol = TOL[dtype]["rtol"]
    for a, b in pairs:
        b = b.float()
        torch.testing.assert_close(a.float(), b, rtol=tol,
                                   atol=tol * b.abs().max().item())


@pytest.mark.parametrize("kernel,shape", [
    ("K1", (2, 128, 4, 2, 64)), ("K2", (1, 512, 4, 2, 64, 128, 256)),
    ("K3", (8, 72, 256, 128))])
def test_wrapper_launches_directly_where_autograd_records_nothing(
        cuda, kernel, shape):
    """Under inference_mode or no_grad, or on inputs that need no gradient,
    a wrapper launches its kernel without its autograd.Function: one
    launch counted, no grad_fn, and the same output as through the
    Function."""
    ins, _, _, _ = _grad_inputs(kernel, shape, torch.bfloat16, cuda)
    if kernel == "K1":
        wrapper, call = ops.flash_attention, ops.flash_attention
    elif kernel == "K2":
        wrapper = ops.ssd_chunked
        call = lambda *t: ops.ssd_chunked(*t, shape[-1])   # noqa: E731
    else:
        wrapper, call = ops.grouped_matmul, ops.grouped_matmul

    def outs(*t):
        out = call(*t)
        return out if isinstance(out, tuple) else (out,)

    want = [o.detach() for o in outs(*[t.clone().requires_grad_()
                                       for t in ins])]
    for mode in (torch.inference_mode, torch.no_grad, torch.enable_grad):
        with mode():
            before = wrapper.launches
            got = outs(*ins)
            assert wrapper.launches == before + 1
        assert all(o.grad_fn is None for o in got)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-130m",
                                  "olmoe-1b-7b", "deepseek-v3-671b",
                                  "whisper-large-v3"])
def test_loss_and_grads_on_the_card_match_cpu(cuda, arch):
    """Model.loss and every gradient of a smoke config in fp32 (remat on:
    each kernel forward launched twice a layer) on the card against CPU
    copies, within 1e-4 of each tensor's max.  deepseek-v3: MLA, MoE
    after a dense layer and the MTP loss; whisper: the encoder over audio
    frames and cross-attention."""
    cfg = configs.get_smoke(arch)
    model = Model(cfg, dtype=torch.float32,
                  device=cuda).init(torch.Generator(cuda).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=gen)}
    if cfg.encoder_layers:
        batch["audio_embeds"] = torch.randn(
            (2, cfg.max_source_positions, cfg.d_model), generator=gen)
    out = []
    for m in (model, cpu):
        loss, _ = m.loss({k: v.to(m.device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out.append((loss.item(), [g.cpu() for g in grads]))
    (loss, grads), (want_loss, want_grads) = out
    assert loss == pytest.approx(want_loss, rel=1e-4)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


def test_serving_prefill_runs_k1_once_per_layer(cuda):
    cfg = configs.get_smoke("chatglm3-6b")
    model = Model(cfg, dtype=torch.float32,
                  device=cuda).init(torch.Generator(cuda).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    with torch.inference_mode():
        cache = model.init_cache(2, 48)
        before = ops.flash_attention.launches
        tok, logits, cache = serve.prefill(model, cache, prompts)
        assert ops.flash_attention.launches == before + cfg.n_layers
        serve.decode(model, cache, tok, 40, 4)
        assert ops.flash_attention.launches == before + cfg.n_layers
        plain = Model(cfg, RunConfig(attn_impl="plain"),
                      dtype=torch.float32, device=cuda)
        plain.load_state_dict(model.state_dict())
        _, want, _ = serve.prefill(plain, plain.init_cache(2, 48), prompts)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


def ssd_inputs(B, L, H, G, P, N, dtype, device, a_scale=1.0, seed=0,
               misalign=0):
    """x [B,L,H,P], dt [B,L,H], A [H], Bm/Cm [B,L,G,N] as the Mamba2 block
    hands them to the kernel: x, B and C are strided views of one packed
    tensor, dt = softplus(normal), A = -a_scale * linspace(1, 16, H).
    ``misalign`` extra leading columns of the packed tensor move the views
    (and their row stride) off 16-byte alignment."""
    rng = np.random.default_rng(seed)
    hp, gn = H * P, G * N
    packed = torch.from_numpy(rng.standard_normal(
        (B, L, misalign + hp + 2 * gn), dtype=np.float32)).to(device, dtype)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, L, H), dtype=np.float32))).to(device)
    A = -a_scale * torch.linspace(1.0, 16.0, H, device=device)
    x = packed[..., misalign:misalign + hp].reshape(B, L, H, P)
    Bm = packed[..., misalign + hp:misalign + hp + gn].reshape(B, L, G, N)
    Cm = packed[..., misalign + hp + gn:].reshape(B, L, G, N)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,L,H,G,P,N,chunk,dtype,a_scale", [
    (2, 64, 8, 1, 16, 16, 8, torch.float32, 1.0),      # smoke shape: Q 8
    (2, 64, 8, 1, 16, 16, 8, torch.bfloat16, 1.0),
    (2, 120, 4, 2, 32, 16, 40, torch.float32, 0.01),   # G 2, ragged tiles
    (1, 100, 4, 2, 64, 128, 100, torch.bfloat16, 0.01),  # Q = L < chunk
    (8, 4096, 24, 1, 64, 128, 256, torch.bfloat16, 1.0),  # serving prefill
    (1, 512, 24, 1, 64, 128, 256, torch.float32, 0.01),
    # the bf16 tensor-core path's edges: Q one 64-row tile, one row over,
    # the remainder of a 1000-token prompt, one row under a chunk; hpg 1,
    # 2 and 24; N 64 and 256; P 32 and 128; the longest chunk it takes at
    # N 128 / P 64, and one tile longer (the CUDA-core kernel)
    (2, 512, 8, 1, 64, 128, 64, torch.bfloat16, 1.0),
    (2, 390, 8, 4, 64, 128, 65, torch.bfloat16, 1.0),
    (2, 232, 24, 1, 64, 128, 232, torch.bfloat16, 1.0),
    (2, 510, 8, 8, 64, 128, 255, torch.bfloat16, 1.0),
    (1, 512, 48, 2, 64, 128, 256, torch.bfloat16, 1.0),
    (2, 512, 24, 1, 64, 64, 256, torch.bfloat16, 1.0),
    (1, 512, 8, 1, 64, 256, 256, torch.bfloat16, 1.0),
    (2, 512, 24, 1, 32, 128, 256, torch.bfloat16, 1.0),
    (1, 512, 8, 2, 128, 256, 256, torch.bfloat16, 0.01),
    (1, 1280, 4, 1, 64, 128, 640, torch.bfloat16, 0.01),
    (1, 1408, 4, 1, 64, 128, 704, torch.bfloat16, 0.01),
])
def test_ssd_kernel_matches_plain(cuda, B, L, H, G, P, N, chunk, dtype,
                                  a_scale):
    x, dt, A, Bm, Cm = ssd_inputs(B, L, H, G, P, N, dtype, cuda, a_scale)
    with torch.inference_mode():
        got = ssd_kernel.ssd_intra_chunk_fwd(x, dt, A, Bm, Cm, chunk)
        want = ref.ssd_intra_chunk_ref(*ref.to_chunks(x, dt, A, Bm, Cm,
                                                      chunk))
        torch.cuda.synchronize()
    for name, g, w in zip(("y", "state", "cum"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, **SSD_TOL[dtype], msg=name)


@pytest.mark.parametrize("misalign,P,N", [(1, 64, 128), (1, 8, 8),
                                           (8, 64, 128)])
def test_ssd_kernel_takes_views_off_16_bytes(cuda, misalign, P, N):
    """x, B and C views whose base or row stride is not a multiple of 16
    bytes (staged element by element), and one that is aligned again."""
    x, dt, A, Bm, Cm = ssd_inputs(2, 500, 4, 2, P, N, torch.bfloat16, cuda,
                                  misalign=misalign)
    with torch.inference_mode():
        got = ssd_kernel.ssd_intra_chunk_fwd(x, dt, A, Bm, Cm, 250)
        want = ref.ssd_intra_chunk_ref(*ref.to_chunks(x, dt, A, Bm, Cm,
                                                      250))
        torch.cuda.synchronize()
    for name, g, w in zip(("y", "state", "cum"), got, want):
        torch.testing.assert_close(g, w, **SSD_TOL[torch.bfloat16], msg=name)


def test_ssd_path_names_the_kernel_each_input_runs(cuda):
    assert ssd_kernel.path(torch.bfloat16, 256, 64, 128).startswith(
        "mma.sync, C B^T once per group")
    assert ssd_kernel.path(torch.bfloat16, 640, 64, 128).startswith(
        "mma.sync, C B^T once per group")
    assert ssd_kernel.path(torch.bfloat16, 704, 64, 128).startswith(
        "bf16 CUDA cores")
    assert ssd_kernel.path(torch.float32, 256, 64, 128).startswith(
        "fp32 CUDA cores")


def test_ssd_chunked_counts_launches_and_takes_grad(cuda):
    x, dt, A, Bm, Cm = ssd_inputs(1, 32, 4, 1, 16, 16, torch.float32, cuda)
    before = ops.ssd_chunked.launches
    with torch.inference_mode():
        y, final = ops.ssd_chunked(x, dt, A, Bm, Cm, 8)
        want_y, want_final = ref.ssd_sequential_ref(x, dt, A, Bm, Cm)
    assert ops.ssd_chunked.launches == before + 1
    torch.testing.assert_close(y, want_y, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(final, want_final, rtol=1e-3, atol=1e-3)
    xg = x.detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(ops.ssd_chunked(xg, dt, A, Bm, Cm, 8)[0]
                               .sum(), xg)
    xc = x.detach().cpu().requires_grad_()
    (want_g,) = torch.autograd.grad(ops.ssd_chunked(
        xc, dt.cpu(), A.cpu(), Bm.cpu(), Cm.cpu(), 8)[0].sum(), xc)
    torch.testing.assert_close(g.cpu(), want_g, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,L,H,G,P,N,chunk,dtype", [
    (2, 64, 8, 1, 16, 16, 8, torch.float32),           # smoke shape: Q 8
    (2, 120, 4, 2, 32, 16, 40, torch.bfloat16),        # G 2
    (8, 4096, 24, 1, 64, 128, 256, torch.bfloat16),    # serving prefill
])
def test_ssd_chunked_matches_its_plain_route(cuda, B, L, H, G, P, N, chunk,
                                             dtype, init):
    """The wrapper as the main path calls it (K2, then the inter-chunk
    recurrence), from a zero or a given state, against the same call on
    CPU copies, which runs K2's plain version."""
    x, dt, A, Bm, Cm = ssd_inputs(B, L, H, G, P, N, dtype, cuda)
    s0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, H, P, N), dtype=np.float32)).to(cuda) if init else None
    with torch.inference_mode():
        y, final = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state=s0)
        want_y, want_final = ops.ssd_chunked(
            *(t.cpu() for t in (x, dt, A, Bm, Cm)), chunk,
            init_state=None if s0 is None else s0.cpu())
    assert y.dtype == dtype and final.dtype == torch.float32
    torch.testing.assert_close(y.cpu(), want_y, **SSD_TOL[dtype])
    torch.testing.assert_close(final.cpu(), want_final,
                               **SSD_TOL[torch.float32])


def test_mamba2_serving_runs_k2_once_per_layer_in_prefill(cuda):
    cfg = configs.get(serve.SSM_ARCH)
    model, requests = serve.setup(cfg, 2, 512, cuda)
    prompts = requests["tokens"]
    with torch.inference_mode():
        cache = model.init_cache(2, 516)
        before = ops.ssd_chunked.launches
        tok, logits, cache = serve.prefill(model, cache, prompts)
        assert ops.ssd_chunked.launches == before + cfg.n_layers == \
            before + 24
        rest, _ = serve.decode(model, cache, tok, 512, 4)
        assert ops.ssd_chunked.launches == before + cfg.n_layers
    assert torch.isfinite(logits).all()
    assert tuple(rest.shape) == (2, 4)


def test_mamba2_ragged_prefill_runs_k2_twice_per_layer(cuda):
    """A 300-token prompt is a chunk of 256 and a remainder of 44: two K2
    launches a layer in the one-call prefill, none in decode; its logits
    agree with token-by-token decode (the sequential recurrence) in fp32."""
    cfg = configs.get(serve.SSM_ARCH)
    model, requests = serve.setup(cfg, 2, 300, cuda, dtype=torch.float32)
    prompts = requests["tokens"]
    with torch.inference_mode():
        cache = model.init_cache(2, 304)
        before = ops.ssd_chunked.launches
        tok, logits, cache = serve.prefill(model, cache, prompts)
        assert ops.ssd_chunked.launches == before + 2 * cfg.n_layers == \
            before + 48
        rest, _ = serve.decode(model, cache, tok, 300, 4)
        assert ops.ssd_chunked.launches == before + 48
        seq = model.init_cache(2, 300)
        by_token = torch.cat([model.decode_step(seq, prompts[:, t:t + 1],
                                                t)[0]
                              for t in range(300)], dim=1)
    assert tuple(rest.shape) == (2, 4)
    torch.testing.assert_close(logits, by_token, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("E,C,d,f,dtype", [
    (2, 16, 32, 32, torch.bfloat16),        # tests/test_kernels.py:137-141
    (4, 64, 128, 64, torch.bfloat16),
    (3, 32, 96, 48, torch.bfloat16),
    (3, 32, 96, 48, torch.float32),
    (8, 8, 64, 32, torch.bfloat16),         # olmoe smoke decode: C 8
    (64, 8, 2048, 1024, torch.bfloat16),    # olmoe decode x@w_gate
    (64, 640, 1024, 2048, torch.bfloat16),  # olmoe prefill h@w_out
    (64, 1280, 2048, 1024, torch.bfloat16),  # olmoe training x@w_gate
    (64, 1280, 1024, 2048, torch.bfloat16),  # olmoe training h@w_out
    (5, 200, 136, 72, torch.float32),       # ragged C, d and f tiles
    (5, 200, 136, 72, torch.bfloat16),
    # the bf16 tilings' edges: C 16, 24 and 64 (64 x 128 tiles), 72, 136
    # and 648 (128 x 256 tiles); d 136; f 72
    (8, 16, 2048, 1024, torch.bfloat16),
    (8, 24, 2048, 1024, torch.bfloat16),
    (8, 64, 2048, 1024, torch.bfloat16),
    (8, 72, 2048, 1024, torch.bfloat16),
    (8, 136, 1024, 2048, torch.bfloat16),
    (4, 648, 2048, 1024, torch.bfloat16),
    (4, 256, 136, 256, torch.bfloat16),
    (4, 256, 512, 72, torch.bfloat16),
])
def test_grouped_matmul_matches_plain(cuda, E, C, d, f, dtype):
    rng = np.random.default_rng(0)
    x, w = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(cuda, dtype) for s in ((E, C, d), (E, d, f)))
    before = ops.grouped_matmul.launches
    with torch.inference_mode():
        got = ops.grouped_matmul(x, w)
        want = ref.gmm_ref(x, w)
        torch.cuda.synchronize()
    assert ops.grouped_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_grouped_matmul_takes_grad_and_refuses_bad_shapes(cuda):
    x = torch.zeros((2, 8, 16), device=cuda)
    w = torch.zeros((2, 16, 8), device=cuda)
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(ops.grouped_matmul(xg, w).sum(), xg)
    assert g.shape == x.shape
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.grouped_matmul(torch.zeros((2, 8, 12), device=cuda),
                           torch.zeros((2, 12, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("capacity_factor", [16.0, 0.5])
def test_moe_apply_on_the_card_matches_its_plain_route(cuda, capacity_factor):
    """The MoE layer on K3 against the same call on CPU copies: the same
    routing and y within bf16's tolerance, with drops at factor 0.5."""
    cfg = dataclasses.replace(configs.get_smoke("olmoe-1b-7b"),
                              capacity_factor=capacity_factor)
    g = torch.Generator(cuda).manual_seed(0)
    p = moe.moe_init(g, cfg, dtype=torch.bfloat16, device=cuda)
    x = torch.randn((2, 32, cfg.d_model), generator=g,
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode(), moe.recorded_routes() as seen:
        y, aux = moe.moe_apply(p, x, cfg)
        want_y, want_aux = moe.moe_apply({k: v.cpu() for k, v in p.items()},
                                         x.cpu(), cfg)
    r, want_r = seen
    for name in ("ids", "tok", "valid", "counts"):
        assert torch.equal(getattr(r, name).cpu(), getattr(want_r, name)), name
    assert (int(want_r.dropped) > 0) == (capacity_factor < 1)
    scale = max(1.0, want_y.abs().max().item())
    torch.testing.assert_close(y.cpu().float(), want_y.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


def test_olmoe_prefill_runs_k3_three_times_per_moe_layer(cuda):
    cfg = configs.get_smoke("olmoe-1b-7b")
    model = Model(cfg, dtype=torch.bfloat16,
                  device=cuda).init(torch.Generator(cuda).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    with torch.inference_mode():
        cache = model.init_cache(2, 30)
        k3, k1 = ops.grouped_matmul.launches, ops.flash_attention.launches
        tok, logits, cache = serve.prefill(model, cache, prompts)
        assert ops.grouped_matmul.launches == k3 + 3 * cfg.n_layers
        assert ops.flash_attention.launches == k1 + cfg.n_layers
        serve.decode(model, cache, tok, 24, 4)
        assert ops.grouped_matmul.launches == k3 + 3 * cfg.n_layers * 5
        assert ops.flash_attention.launches == k1 + cfg.n_layers
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("E,C,d,f", [
    (256, 160, 7168, 2048),     # deepseek-v3 prefill x@w_gate, x@w_in
    (256, 160, 2048, 7168),     # deepseek-v3 prefill h@w_out
    (256, 8, 7168, 2048),       # deepseek-v3 decode
    (256, 8, 2048, 7168),
])
def test_grouped_matmul_at_deepseek_v3_shapes(cuda, E, C, d, f):
    """K3 at 256 experts and d_model 7168 (bf16): C 160 is no multiple of
    the 128-row tile, and d 7168 the longest reduction it runs."""
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((E, C, d), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((E, d, f), generator=g, device=cuda).to(torch.bfloat16)
    before = ops.grouped_matmul.launches
    with torch.inference_mode():
        got = ops.grouped_matmul(x, w)
        want = ref.gmm_ref(x, w)
        torch.cuda.synchronize()
    assert ops.grouped_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-large-v3"])
def test_mla_and_whisper_serving_launch_counts(cuda, arch):
    """deepseek-v3 (smoke, fp32): the one-call prefill launches K1 once a
    layer (MLA at its qk/v head dims) and K3 three times for the MoE
    layer; a decode step (absorbed, in the latent space) K3 three times
    and K1 never.  whisper: encoding launches K1 once an encoder layer
    (non-causal), the prefill once a decoder layer, decode never.  The
    kernel path's logits equal the plain path's within fp32's 1e-4 (in
    bf16 the smoke MoE's top-2 of 8 experts flips on near-ties)."""
    cfg = configs.get_smoke(arch)
    model, requests = serve.setup(cfg, 2, 24, cuda, dtype=torch.float32)
    n_moe = sum(spec.ffn == "moe" for seg in model.segments_spec
                for spec in seg.pattern for _ in range(seg.repeats))
    with torch.inference_mode():
        k1, k3 = ops.flash_attention.launches, ops.grouped_matmul.launches
        enc = serve.encode(model, requests)
        assert ops.flash_attention.launches == k1 + cfg.encoder_layers
        cache = model.init_cache(2, 30)
        tok, logits, cache = serve.prefill(model, cache, requests["tokens"],
                                           enc)
        assert ops.flash_attention.launches == \
            k1 + cfg.encoder_layers + cfg.n_layers
        assert ops.grouped_matmul.launches == k3 + 3 * n_moe
        serve.decode(model, cache, tok, 24, 4, enc)
        assert ops.flash_attention.launches == \
            k1 + cfg.encoder_layers + cfg.n_layers
        assert ops.grouped_matmul.launches == k3 + 3 * n_moe * 5
        model.run = dataclasses.replace(model.run, attn_impl="plain")
        plain_enc = serve.encode(model, requests)
        _, want, _ = serve.prefill(model, model.init_cache(2, 30),
                                   requests["tokens"], plain_enc)
    assert n_moe == (1 if cfg.n_experts else 0)
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


def test_optimizer_extras_on_the_card_match_cpu(cuda, monkeypatch):
    """The int8 quantisation of the moments and the fp8 compression of a
    gradient are elementwise, exactly rounded operations: on the card they
    give the CPU's codes and scales bit for bit; and one 8-bit AdamW step
    of a slice-walked stack (``SLICE_NUMEL`` one slice) equals the CPU's to
    fp32 rounding."""
    from repro_torch.optim import AdamW, AdamWConfig, adamw, compression
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 96, 256), dtype=np.float32)
                         * np.exp(rng.standard_normal((4, 96, 1))
                                  ).astype(np.float32))
    x[1, 3] = 0.0
    for got, want in zip(adamw._quant8(x.to(cuda)), adamw._quant8(x)):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    err = torch.from_numpy(1e-3 * rng.standard_normal(x.shape,
                                                      dtype=np.float32))
    got = compression.compress_leaf(x.to(cuda, torch.bfloat16),
                                    err.to(cuda))
    want = compression.compress_leaf(x.to(torch.bfloat16), err)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=0,
                                   atol=0)

    monkeypatch.setattr(adamw, "SLICE_NUMEL", 96 * 256)
    out = []
    for dev in (cuda, torch.device("cpu")):
        mod = torch.nn.Module()
        mod.w = torch.nn.Parameter(x.to(dev, copy=True))
        opt = AdamW(AdamWConfig(lr=1e-2, state_8bit=True))
        state = opt.init(mod)
        opt.update({"w": (x * 0.1).to(dev)}, state, mod)
        out.append((mod.w.detach().cpu(), state["m"]["w"]["q"].cpu()))
    (w, q), (want_w, want_q) = out
    torch.testing.assert_close(w, want_w, rtol=1e-6, atol=1e-6)
    assert (q.int() - want_q.int()).abs().max() <= 1
