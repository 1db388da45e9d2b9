"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here carries the `cuda` marker and skips
without a GPU. The file imports no JAX, so it runs on a GPU machine without
it (there: `python -m pytest tests/test_torch_kernels_cuda.py -m cuda
--noconftest -q`, since tests/conftest.py pins JAX)."""

import pytest
import torch

from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


KERNEL_CASES = [
    # B, S, H, KV, D, causal, dtype
    (1, 4096, 32, 8, 64, True, torch.bfloat16),
    (2, 512, 4, 4, 128, False, torch.float32),
    (1, 1024, 8, 2, 32, True, torch.bfloat16),
    (2, 48, 4, 1, 64, True, torch.float32),
    (1, 200, 2, 2, 64, False, torch.bfloat16),
    # the head width of an 8B-class Llama, causal GQA
    (1, 2048, 32, 8, 128, True, torch.bfloat16),
    # ragged S (not a multiple of the 64-row tiles), causal, GQA 2
    (1, 200, 4, 2, 64, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,H,KV,D,causal,dtype", KERNEL_CASES)
def test_flash_fwd_matches_plain_version(cuda_device, B, S, H, KV, D, causal, dtype):
    """o is held per row: max |err| of each (b, s, h) vector over that
    row's max |o_ref|, so late causal rows with small |o| count as much as
    early ones. bf16: o within 2^-6 of the row (each side rounds p and o to
    bf16, up to 2^-8 relative each; the kernel rounds p against its running max,
    the plain version against the row max), lse within 1e-3. f32: o within
    1e-5 of the row, lse within 1e-4 (sum order only)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (
        torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    )
    before = fa.FLASH_FWD.launches
    with torch.no_grad():
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal, block_q=8, block_kv=8)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=causal)
    o_tol, lse_tol = (2.0 ** -6, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    assert o.dtype == dtype and lse.dtype == torch.float32
    err = (o.float() - o_ref.float()).abs().amax(-1)
    assert (err / o_ref.float().abs().amax(-1)).max().item() < o_tol
    assert (lse - lse_ref).abs().max().item() < lse_tol


def test_flash_fwd_reads_strided_inputs(cuda_device):
    """q/k/v as views of one fused projection (non-contiguous heads)."""
    B, S, H, KV, D = 2, 256, 4, 2, 64
    qkv = torch.randn(B, S, (H + 2 * KV) * D, device=cuda_device)
    q = qkv[..., : H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + KV) * D].view(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].view(B, S, KV, D)
    assert not q.is_contiguous()
    with torch.no_grad():
        o = fa.flash_attention(q, k, v)
    ref, _ = fa.flash_attention_reference(q, k, v)
    assert (o - ref).abs().max().item() < 1e-4


def _bf16_qkv(B, S, H, KV, D, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [
        torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    ]


def test_flash_fwd_bf16_reads_strided_inputs(cuda_device):
    """The wgmma forward copies q/k/v as views of one fused bf16 projection
    (non-contiguous heads, rows 16-byte aligned) by stride and gives the
    same bits as on contiguous copies."""
    B, S, H, KV, D = 2, 320, 4, 2, 64
    q, k, v = _bf16_qkv(B, S, H, KV, D, cuda_device)
    qkv = torch.cat([t.reshape(B, S, -1) for t in (q, k, v)], dim=-1)
    views = (qkv[..., : H * D].view(B, S, H, D),
             qkv[..., H * D:(H + KV) * D].view(B, S, KV, D),
             qkv[..., (H + KV) * D:].view(B, S, KV, D))
    assert not views[0].is_contiguous()
    with torch.no_grad():
        got = fa.flash_attention_lse(*views, block_q=64, block_kv=64)
        dense = fa.flash_attention_lse(q, k, v, block_q=64, block_kv=64)
    for a, b in zip(got, dense):
        assert torch.equal(a, b)


def test_flash_fwd_is_deterministic(cuda_device):
    """No atomics: two launches give the same bits."""
    q, k, v = _bf16_qkv(1, 1024, 8, 2, 64, cuda_device)
    runs = [fa.FLASH_FWD(q, k, v, causal=True, scale=0.125) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_fwd_refuses_misaligned_rows(cuda_device):
    """The bf16 forward copies rows 16 bytes at a time: a row stride of
    D + 4 elements (8 bytes off the grid) raises before any launch; the same
    values in an aligned layout run."""
    B, S, H, KV, D = 1, 128, 4, 2, 64
    q, k, v = _bf16_qkv(B, S, H, KV, D, cuda_device)
    wide = torch.zeros(B, S, KV, D + 4, dtype=torch.bfloat16, device=cuda_device)
    wide[..., :D] = k
    skewed = wide[..., :D]
    assert skewed.stride(-1) == 1 and skewed.stride(2) * 2 % 16 == 8
    before = fa.FLASH_FWD.launches
    with pytest.raises(ValueError, match="16-byte aligned rows: k"):
        fa.FLASH_FWD(q, skewed, v, causal=True, scale=D ** -0.5)
    assert fa.FLASH_FWD.launches == before
    o, lse = fa.FLASH_FWD(q, skewed.contiguous(), v, causal=True, scale=D ** -0.5)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v)
    assert _row_rel(o, o_ref) < 2.0 ** -6
    assert (lse - lse_ref).abs().max().item() < 1e-3


def test_flash_grad_flows_through_the_kernels(cuda_device):
    """Autograd through flash_attention_lse launches the forward kernel once
    and each backward kernel once, and its gradients (with cotangents on o
    and lse) equal autograd through the plain forward (f32, 1e-4 of each
    row: sum order only)."""
    B, S, H, KV, D = 2, 256, 8, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    leaves = [
        torch.randn(shape, generator=gen, device=cuda_device)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    ]
    do = torch.randn(B, S, H, D, generator=gen, device=cuda_device)
    dlse = torch.randn(B, H, S, generator=gen, device=cuda_device)
    before = [kern.launches for kern in fa.KERNELS]
    grads = []
    for fn in (fa.flash_attention_lse, fa.flash_attention_reference):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        o, lse = fn(q, k, v)
        torch.autograd.backward([o, lse], [do, dlse])
        grads.append([q.grad, k.grad, v.grad])
    assert [kern.launches for kern in fa.KERNELS] == [n + 1 for n in before]
    for ours, want in zip(*grads):
        assert _row_rel(ours, want) < 1e-4


def _row_rel(out, ref):
    """max over rows (the last dim) of max |out - ref| / max |ref|, a row's
    max |ref| floored at a thousandth of the tensor's (dq of the first
    causal query is 0 up to rounding)."""
    out, ref = out.float(), ref.float()
    scale = ref.abs().amax(-1)
    floor = max(1e-3 * scale.max().item(), 1e-30)
    return ((out - ref).abs().amax(-1) / scale.clamp_min(floor)).max().item()


def _bwd_inputs(B, S, H, KV, D, causal, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (
        torch.randn(shape, generator=gen, device=device).to(dtype)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    )
    do = torch.randn((B, S, H, D), generator=gen, device=device).to(dtype)
    with torch.no_grad():
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal, block_q=8, block_kv=8)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, o, lse, do, delta


@pytest.mark.parametrize("B,S,H,KV,D,causal,dtype", KERNEL_CASES)
def test_flash_bwd_matches_plain_version(cuda_device, B, S, H, KV, D, causal, dtype):
    """dq, dk and dv held per row against flash_attention_bwd_reference.
    bf16: within 2^-6 of the row. Both sides round ds (and p) to bf16 at
    the same points from nearly the same f32 values, so those roundings
    rarely differ; each side rounds its output to bf16 (2^-8 relative), so
    the two may sit 2^-7 apart, and 2^-6 leaves 2x room. f32: 1e-4 of the
    row (sum order only; ds = p * (dp - delta) can cancel)."""
    q, k, v, o, lse, do, delta = _bwd_inputs(B, S, H, KV, D, causal, dtype, cuda_device)
    before = (fa.FLASH_DQ.launches, fa.FLASH_DKV.launches)
    dq = fa.FLASH_DQ(q, k, v, do, lse, delta, causal=causal, scale=D ** -0.5)
    dk, dv = fa.FLASH_DKV(q, k, v, do, lse, delta, causal=causal, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (fa.FLASH_DQ.launches, fa.FLASH_DKV.launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, delta, causal=causal)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-4
    for ours, ref in zip((dq, dk, dv), want):
        assert ours.dtype == dtype and ours.shape == ref.shape
        assert _row_rel(ours, ref) < tol


def test_flash_bwd_reads_strided_do(cuda_device):
    """dO as a view with non-contiguous heads is read by stride, and the
    kernels' results do not depend on the layout."""
    B, S, H, KV, D = 2, 256, 4, 2, 64
    q, k, v, o, lse, do, delta = _bwd_inputs(B, S, H, KV, D, True, torch.float32, cuda_device)
    wide = torch.zeros(B, S, 2 * H, D, device=cuda_device)
    wide[:, :, ::2] = do
    strided = wide[:, :, ::2]
    assert not strided.is_contiguous() and strided.stride(-1) == 1
    got = (fa.FLASH_DQ(q, k, v, strided, lse, delta, causal=True, scale=D ** -0.5),
           *fa.FLASH_DKV(q, k, v, strided, lse, delta, causal=True, scale=D ** -0.5))
    dense = (fa.FLASH_DQ(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5),
             *fa.FLASH_DKV(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5))
    for a, b in zip(got, dense):
        assert torch.equal(a, b)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, delta)
    for a, b in zip(got, want):
        assert _row_rel(a, b) < 1e-4


def test_flash_bwd_bf16_reads_strided_inputs(cuda_device):
    """The wgmma kernels copy q, k and v as views of one fused projection and
    dO with non-contiguous heads by stride (rows 16-byte aligned) and give
    the same bits as on contiguous copies."""
    B, S, H, KV, D = 2, 320, 4, 2, 64
    q, k, v, o, lse, do, delta = _bwd_inputs(B, S, H, KV, D, True, torch.bfloat16, cuda_device)
    qkv = torch.cat([t.reshape(B, S, -1) for t in (q, k, v)], dim=-1)
    views = (qkv[..., : H * D].view(B, S, H, D),
             qkv[..., H * D:(H + KV) * D].view(B, S, KV, D),
             qkv[..., (H + KV) * D:].view(B, S, KV, D))
    wide = torch.zeros(B, S, 2 * H, D, dtype=torch.bfloat16, device=cuda_device)
    wide[:, :, 1::2] = do
    strided = wide[:, :, 1::2]
    assert not views[0].is_contiguous() and not strided.is_contiguous()
    got = (fa.FLASH_DQ(*views, strided, lse, delta, causal=True, scale=D ** -0.5),
           *fa.FLASH_DKV(*views, strided, lse, delta, causal=True, scale=D ** -0.5))
    dense = (fa.FLASH_DQ(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5),
             *fa.FLASH_DKV(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5))
    for a, b in zip(got, dense):
        assert torch.equal(a, b)


def test_flash_bwd_is_deterministic(cuda_device):
    """No atomics: two runs give the same bits."""
    q, k, v, o, lse, do, delta = _bwd_inputs(1, 512, 8, 2, 64, True, torch.bfloat16, cuda_device)
    runs = [
        (fa.FLASH_DQ(q, k, v, do, lse, delta, causal=True, scale=0.125),
         *fa.FLASH_DKV(q, k, v, do, lse, delta, causal=True, scale=0.125))
        for _ in range(2)
    ]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_bwd_refuses_misaligned_rows(cuda_device):
    """The bf16 kernels copy rows 16 bytes at a time: a row stride of
    D + 4 elements (8 bytes off the grid) raises before any launch; the same
    values in an aligned layout run."""
    B, S, H, KV, D = 1, 128, 4, 2, 64
    q, k, v, o, lse, do, delta = _bwd_inputs(B, S, H, KV, D, True, torch.bfloat16, cuda_device)
    wide = torch.zeros(B, S, H, D + 4, dtype=torch.bfloat16, device=cuda_device)
    wide[..., :D] = do
    skewed = wide[..., :D]
    assert skewed.stride(-1) == 1 and skewed.stride(2) * 2 % 16 == 8
    before = (fa.FLASH_DQ.launches, fa.FLASH_DKV.launches)
    for kernel in (fa.FLASH_DQ, fa.FLASH_DKV):
        with pytest.raises(ValueError, match="16-byte aligned rows: dO"):
            kernel(q, k, v, skewed, lse, delta, causal=True, scale=D ** -0.5)
    assert (fa.FLASH_DQ.launches, fa.FLASH_DKV.launches) == before
    dq = fa.FLASH_DQ(q, k, v, skewed.contiguous(), lse, delta, causal=True, scale=D ** -0.5)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, delta)
    assert _row_rel(dq, want[0]) < 2.0 ** -6


def test_flash_fwd_refuses_unsupported_inputs(cuda_device):
    q = torch.randn(1, 64, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    h = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(h, h, h)
    f = torch.randn(1, 64, 2, 64, device=cuda_device)
    lse = torch.zeros(1, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.FLASH_DQ(f, f, f, f.bfloat16(), lse, lse, causal=True, scale=0.1)
    q48 = torch.randn(1, 64, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.FLASH_DKV(q48, q48, q48, q48, lse, lse, causal=True, scale=0.1)


def test_model_forward_launches_once_per_layer(cuda_device):
    cfg = dict(dim=128, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512,
               seq_len=256, attention="flash")
    model = build_model("transformer_lm", cfg, dtype=torch.bfloat16).module
    ref = build_model("transformer_lm", {**cfg, "attention": "xla"},
                      dtype=torch.bfloat16).module
    tokens = torch.randint(0, 512, (2, 256), device=cuda_device)
    before = fa.FLASH_FWD.launches
    with torch.inference_mode():
        out, want = model(tokens).float(), ref(tokens).float()
    assert fa.FLASH_FWD.launches == before + 3
    assert ((out - want).norm() / want.norm()).item() < 2e-2


def test_training_step_launches_dq_and_dkv_once_per_layer(cuda_device):
    """One optimizer step of a 3-layer model under `attention: flash`: the
    forward kernel once per layer (no remat) and each backward kernel once
    per layer; the step moves the loss like the einsum path's step."""
    from polyaxon_tpu_torch.runtime import Trainer

    def program(attention):
        return {
            "model": {"name": "transformer_lm", "config": dict(
                dim=128, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512,
                seq_len=256, attention=attention)},
            "data": {"name": "synthetic_text", "batchSize": 2,
                     "config": {"seq_len": 256, "vocab_size": 512}},
            "train": {"steps": 2, "logEvery": 1, "precision": "mixed"},
        }

    flash = Trainer(program("flash"))
    ref = Trainer(program("xla"))
    ref.load_state_dict(flash.module.state_dict())
    before = [kern.launches for kern in fa.KERNELS]
    got = flash.run().history
    assert [kern.launches - n for kern, n in zip(fa.KERNELS, before)] == [6, 6, 6]
    want = ref.run().history
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) < 2e-2 * abs(b["loss"])


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A 3-layer flash trainer saves at its boundary (device snapshot,
    background write); a second trainer resumed from it holds the same
    weights, Adam moments, count and step bit for bit, on the card, and
    trains on from there."""
    from polyaxon_tpu_torch.runtime import Trainer
    from polyaxon_tpu_torch.runtime import checkpoint as ck

    def program(steps, **train):
        return {
            "model": {"name": "transformer_lm", "config": dict(
                dim=128, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=512,
                seq_len=256, attention="flash")},
            "data": {"name": "synthetic_text", "batchSize": 2,
                     "config": {"seq_len": 256, "vocab_size": 512}},
            "optimizer": {"name": "adamw", "learningRate": 1e-3,
                          "schedule": {"name": "cosine", "warmup_steps": 1}},
            "train": {"steps": steps, "logEvery": 1, "precision": "mixed",
                      "remat": True, "checkpointEvery": 2, **train},
        }

    first = Trainer(program(2), checkpoint_dir=str(tmp_path))
    first.run()
    again = Trainer(program(3, resume=True), checkpoint_dir=str(tmp_path))
    assert again.restore() == 2
    want, got = first.checkpoint_state(), again.checkpoint_state()
    assert got["step"] == want["step"] == 2
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 2
    for name, t in want["model"].items():
        assert got["model"][name].is_cuda and torch.equal(got["model"][name], t), name
    for i, state in want["optimizer"]["state"].items():
        for k, t in state.items():
            assert torch.equal(got["optimizer"]["state"][i][k], t), (i, k)
    history = again.run().history
    assert [h["step"] for h in history] == [3]
    assert torch.isfinite(torch.tensor(history[0]["loss"]))
    ck.close_all()


INT8_CASES = [
    # M, K, N: decode rows (the weight-streaming kernel) and prefill rows
    # (the tiled kernels), at llama3-1b's projection shapes and ragged ones
    (1, 2048, 2048), (8, 2048, 512), (5, 8192, 2048), (8, 2048, 8192),
    (64, 2048, 512), (300, 512, 200), (9, 48, 72), (2048, 2048, 2048),
    # the rows the wgmma kernel takes on the main path (9-16: past the
    # decode kernel; 255/264: a chunk, 8 decode rows + a chunk; 2304: a
    # full step), at the q/o, k/v and down shapes
    *[(M, K, N) for M in (9, 16, 64, 255, 264, 2304)
      for K, N in ((2048, 2048), (2048, 512), (8192, 2048))],
]
# one x against 1-4 projections (K, the N of each): q/k/v and gate/up of
# llama3-1b, and a ragged four
INT8_GROUPS = [(2048, (2048, 512, 512)), (2048, (8192, 8192)), (512, (72, 200, 16, 1000))]


def _int8_inputs(M, K, N, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    wq = torch.randint(-127, 128, (N, K), generator=gen, device=device).to(torch.int8)
    scale = torch.rand((N,), generator=gen, device=device) / 127 + 1e-4
    return x, wq, scale


def _int8_rel(out, ref):
    """max over rows of max |err| / max |ref| of that row."""
    err = (out.float() - ref.float()).abs().amax(-1)
    return (err / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", INT8_CASES)
def test_int8_matmul_matches_plain_version(cuda_device, M, K, N, dtype):
    """Held per row against (x.float() @ wq.float().T) * scale cast to x's
    dtype: bf16 within 2^-7 (each side rounds the f32 sum to bf16 once, up
    to 2^-8 relative each), f32 within 1e-5 (sum order only)."""
    from polyaxon_tpu_torch.ops import int8_matmul as im

    x, wq, scale = _int8_inputs(M, K, N, dtype, cuda_device)
    before = im.INT8_MATMUL.launches
    y = im.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert im.INT8_MATMUL.launches == before + 1
    assert y.dtype == dtype and y.shape == (M, N)
    ref = im.int8_matmul_reference(x, wq, scale)
    assert _int8_rel(y, ref) < (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)


def _int8_tol(dtype):
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 8, 9, 256, 264, 2048])
@pytest.mark.parametrize("K,Ns", INT8_GROUPS)
def test_int8_matmul_group_matches_plain_version(cuda_device, K, Ns, M, dtype):
    """One grouped launch (one count), each member held per row against
    its plain version (bf16 2^-7, f32 1e-5, as the single call), and two
    calls give the same bits (K splits reduce in a fixed order)."""
    from polyaxon_tpu_torch.models.quant import quantize_kernel
    from polyaxon_tpu_torch.ops import int8_matmul as im

    gen = torch.Generator(device=cuda_device).manual_seed(M + K)
    x = torch.randn((M, K), generator=gen, device=cuda_device).to(dtype)
    pairs = [quantize_kernel(torch.randn((n, K), generator=gen, device=cuda_device))
             for n in Ns]
    before = im.INT8_MATMUL.launches
    ys = im.int8_matmul_group(x, pairs)
    again = im.int8_matmul_group(x, pairs)
    torch.cuda.synchronize()
    assert im.INT8_MATMUL.launches == before + 2
    for y, y2, (wq, scale), n in zip(ys, again, pairs, Ns):
        assert y.shape == (M, n) and y.dtype == dtype
        assert torch.equal(y, y2)
        assert _int8_rel(y, im.int8_matmul_reference(x, wq, scale)) < _int8_tol(dtype)


@pytest.mark.parametrize("M", [1, 8, 9, 256, 264, 2048])
@pytest.mark.parametrize(
    "K,Ns",
    [(2048, (2048, 512, 512)), (2048, (2048,)), (2048, (8192, 8192)), (8192, (2048,))],
    ids=["qkv", "o", "gate_up", "down"],
)
def test_int8_plan_is_a_function_of_shapes_within_the_kernels_limits(cuda_device, K, Ns, M):
    """The launch plan (tile width, K splits), read from the C side: the
    same every time, (0, 1) for f32, and within the kernels' limits (K
    splits of 2-4 only while the split blocks fit in one wave)."""
    from polyaxon_tpu_torch.ops import int8_matmul as im

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tile_n, splits = im.INT8_MATMUL.plan(M, K, Ns)
    assert (tile_n, splits) == im.INT8_MATMUL.plan(M, K, Ns)
    assert im.INT8_MATMUL.plan(M, K, Ns, torch.float32) == (0, 1)
    assert splits in (1, 2, 4)
    if M <= 8:
        tiles = sum(-(-n // 64) for n in Ns)
        assert tile_n == 0 and splits <= -(-K // 128)
    else:
        assert tile_n in (128, 256) and K // 64 >= 4 * splits
        tiles = sum(-(-n // tile_n) for n in Ns) * -(-M // 128)
    assert splits == 1 or tiles * splits <= sms


def test_int8_matmul_is_deterministic(cuda_device):
    """Repeated calls at split-K shapes (decode o and down, a prefill
    chunk) give the same bits."""
    from polyaxon_tpu_torch.ops import int8_matmul as im

    for M, K, N in ((8, 2048, 2048), (8, 8192, 2048), (256, 8192, 2048), (264, 2048, 2048)):
        x, wq, scale = _int8_inputs(M, K, N, torch.bfloat16, cuda_device, seed=M)
        first = im.int8_matmul(x, wq, scale)
        for _ in range(3):
            assert torch.equal(im.int8_matmul(x, wq, scale), first)


def test_int8_matmul_reads_strided_activations(cuda_device):
    """x out of a transposing reshape (not contiguous) and a leading batch
    shape give the same y as the packed input."""
    from polyaxon_tpu_torch.ops import int8_matmul as im

    x, wq, scale = _int8_inputs(6, 512, 256, torch.bfloat16, cuda_device, seed=1)
    strided = x.reshape(3, 2, 512).transpose(0, 1)  # [2, 3, 512], not contiguous
    assert not strided.is_contiguous()
    y = im.int8_matmul(strided, wq, scale)
    ref = im.int8_matmul(strided.contiguous(), wq, scale)
    assert torch.equal(y, ref) and y.shape == (2, 3, 256)


def test_int8_model_decodes_through_the_kernel(cuda_device):
    """A quantized 2-layer model: its projections launch the kernel 4
    times a layer and forward (q/k/v grouped, o, gate/up grouped, down),
    and a greedy decode on the int8 paged pool
    (prefill, then one chunk of steps) launches it on every step and gives
    the tokens the plain versions give on the same weights."""
    from polyaxon_tpu_torch.models.generate import (
        make_paged_cache, paged_decode_chunk, paged_prefill,
    )
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
    from polyaxon_tpu_torch.models.quant import quantize_module
    from polyaxon_tpu_torch.ops import int8_matmul as im

    model = build_model(
        "transformer_lm", dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                               vocab_size=512, seq_len=128),
        device="cuda", dtype=torch.float32, seed=0,
    ).module.eval()
    qmodel, saved = quantize_module(model)
    assert saved > 0
    prompt = torch.randint(0, 512, (2, 16), device=cuda_device)
    before = im.INT8_MATMUL.launches
    with torch.no_grad():
        qmodel(prompt)
    assert im.INT8_MATMUL.launches == before + 4 * 2
    layout = PagedKVLayout(8, 1 + 2 * 3, kv_quant="int8")  # 24 slots a row
    new = 8

    def decode(module):
        cache = make_paged_cache(module, layout)
        assert cache[0][0].dtype == torch.int8 and cache[0][2].dtype == torch.float32
        tables = 1 + torch.arange(6).reshape(2, 3)
        common = dict(pad=[0, 0], pages=tables, kv_layout=layout, prefix_len=0,
                      temperature=0.0, top_k=None, seeds=[0, 0])
        first = paged_prefill(module, cache, prompt, **common)
        rest, _ = paged_decode_chunk(module, cache, first, [False, False], steps=new - 1,
                                     pos=prompt.shape[1], start_g=1, eos_id=None, **common)
        return torch.cat([first[:, None], rest], 1).cpu()

    before = im.INT8_MATMUL.launches
    out = decode(qmodel)
    assert im.INT8_MATMUL.launches == before + 4 * 2 * new
    ref = decode(qmodel.to("cpu"))
    assert torch.equal(out, ref)
