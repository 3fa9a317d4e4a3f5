"""The tensor-core SSD scan's decomposition and launcher, on the CPU.

``ref.ssd_scan_three_pass`` is the plain PyTorch form of the bf16 kernel
(csrc/ssd_scan_wgmma.cu): chunk states, the state passed across chunks,
then each chunk's output.  In f32 it is held against the reference's
Pallas kernel in interpret mode and its oracle, and against the port's
``ref.ssd_scan_ref``, within 1e-4 · max |ref|, the f32 SSD limit of the
CUDA tests and ``chip_smoke.py``: at chunk 256 every f32 form is ~1e-5 of
max from a float64 evaluation, because exp(cum_t − cum_u) turns the
cumsum's absolute error into a relative one.  With bf16 inputs it is held
against the interpret-mode kernel within 2^-7 · max, one bf16 ulp at the
largest value.  With the kernel's three bf16 roundings emulated (B·w, the
entering state, the decayed scores) it stays within the kernel's limit of
2^-7 · max of the f32 plain path.  Shapes are the CUDA tests': chunk 256,
a ragged S whose chunk halves to 8, S = 100 below the chunk, G = 2 and 4.

The launcher's dispatch (bf16 to the tensor-core library, f32 to the FFMA
library, each with its scratch), its operand checks, ``tc_layout`` and
``ffma_layout`` run here with the launch recorded in place of the kernel;
the kernels themselves run in tests/test_torch_cuda.py and
``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_launcher

BF16_TOL = 2.0 ** -7
F32_TOL = 1e-4

CASES = [                     # (b, s, h, p, g, n, chunk)
    (2, 512, 4, 64, 1, 128, 256),   # the model's head_dim and d_state
    (1, 1000, 4, 32, 2, 64, 256),   # ragged: the chunk halves to 8
    (2, 100, 8, 16, 4, 16, 256),    # S < chunk: one chunk of 100
    (1, 192, 2, 64, 2, 128, 64),    # one 64-row tile per chunk, G = 2
]


def _operands(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (0.5 * np.abs(rng.normal(size=(b, s, h)))).astype(np.float32),
            -np.abs(rng.normal(size=(h,))).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_three_pass_matches_pallas_interpret(b, s, h, p, g, n, chunk, dtype):
    x, dt, a, bm, cm = _operands(0, b, s, h, p, g, n)
    if dtype == "f32":
        jx, jb, jc = (jnp.asarray(v) for v in (x, bm, cm))
        tx, tb, tc = (torch.as_tensor(v) for v in (x, bm, cm))
    else:
        jx, jb, jc = (jnp.asarray(v, jnp.bfloat16) for v in (x, bm, cm))
        tx, tb, tc = (_bf16(v) for v in (x, bm, cm))
    want, _ = pallas_ssd(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc,
                         chunk=chunk, interpret=True)
    got = ref.ssd_scan_three_pass(tx, torch.as_tensor(dt),
                                  torch.as_tensor(a), tb, tc, chunk=chunk)
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want, np.float32),
           F32_TOL if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_three_pass_matches_the_plain_scan(b, s, h, p, g, n, chunk):
    """Against the port's chunked scan at every case, and against the
    reference's oracle where the chunk divides S."""
    args = _operands(1, b, s, h, p, g, n)
    got = ref.ssd_scan_three_pass(*(torch.as_tensor(v) for v in args),
                                  chunk=chunk)
    _close(got, ref.ssd_scan_ref(*(torch.as_tensor(v) for v in args),
                                 chunk=chunk), F32_TOL)
    if s % chunk == 0:
        _close(got, jref.ssd_scan_ref(*(jnp.asarray(v) for v in args),
                                      chunk=chunk), F32_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 256, 16, 32, 1, 32, 32),      # the reduced Mamba-2's scan widths
    (1, 1024, 4, 64, 1, 128, 256),    # Mamba-2 1.3B's head_dim and d_state
    (1, 1000, 4, 32, 2, 64, 256),     # chunk 8
    (2, 100, 8, 16, 4, 16, 256),      # one chunk of 100
])
def test_bf16_roundings_stay_within_the_kernel_limit(b, s, h, p, g, n,
                                                     chunk):
    """bf16 inputs: the decomposition with the kernel's three roundings
    against the f32 plain path (y rounded to bf16 by both) within 2^-7 of
    max; each rounding alone moves y by less than that."""
    x, dt, a, bm, cm = _operands(2, b, s, h, p, g, n)
    args = (_bf16(x), torch.as_tensor(dt), torch.as_tensor(a), _bf16(bm),
            _bf16(cm))
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    exact = ref.ssd_scan_three_pass(*args, chunk=chunk)
    rounded = ref.ssd_scan_three_pass(*args, chunk=chunk, round_bf16=True)
    assert rounded.dtype == torch.bfloat16
    _close(exact, want.float(), BF16_TOL)
    _close(rounded, want.float(), BF16_TOL)
    assert not torch.equal(rounded, exact)   # the roundings do act


@pytest.mark.parametrize("b,s,want", [
    (4, 4096, {"chunks": 16, "pass1_grid": (16, 64, 4),
               "pass2_grid": (32, 256), "pass3_grid": (16, 64, 4)}),
    (1, 32768, {"chunks": 128, "pass1_grid": (128, 64, 1),
                "pass2_grid": (32, 64), "pass3_grid": (128, 64, 1)})])
def test_tc_layout_at_the_prefill_shapes(b, s, want):
    """Mamba-2 1.3B (64 heads, P 64, N 128, chunk 256): a block per chunk
    and head for the states and for the output (4,096 at 4 x 4096 against
    the FFMA kernel's 256), four warpgroups in an output block, and
    scratch of 134 / 268 MB of f32 states beside half that in bf16."""
    lay = ssd_launcher.tc_layout(b, s, 64, 64, 128, 256)
    assert {k: lay[k] for k in want} == want
    states = b * 64 * (s // 256) * 128 * 64
    assert lay["scratch_bytes"] == 6 * states + 4 * b * 64 * s \
        + 4 * b * 64 * (s // 256)
    assert 4 * states == 134217728 * b * s // (4 * 4096)


def test_tc_layout_shared_memory():
    """Pass 1 holds a chunk's B·w (two 64-column blocks) and x, 256 rows
    of 128 bytes each, two blocks an SM; pass 3 the chunk's C and B (two
    column blocks each), x and the entering state (128 rows), one block of
    four warpgroups an SM (228 KB an SM, 1 KB reserved a block; static
    arrays of dt, cum and w in pass 1, cum and dt in pass 3, 1 KB each)."""
    lay = ssd_launcher.tc_layout(1, 512, 4, 16, 16, 256)
    assert lay["pass1_smem_bytes"] == 3 * 256 * 128 + 1024 == 99328
    assert 2 * (lay["pass1_smem_bytes"] + 3072 + 1024) <= 233472
    assert lay["pass3_smem_bytes"] == 5 * 256 * 128 + 128 * 128 + 1024 \
        == 181248
    assert lay["pass3_smem_bytes"] + 2048 + 1024 <= 233472
    assert lay["pass3_threads"] == 512
    assert ssd_launcher.tc_layout(2, 300, 4, 16, 16, 100)["pass3_grid"] \
        == (3, 4, 2)
    for s, chunk in ((100, 64), (512, 512)):
        with pytest.raises(ValueError, match="chunk"):
            ssd_launcher.tc_layout(1, s, 4, 16, 16, chunk)


def test_ffma_layout_fits_and_covers_every_chunk():
    """The FFMA (f32) route at every chunk the launcher accepts (1..256,
    three chunks of batch 2 and 4 heads at the model's P 64 and N 128): a
    block per chunk in passes 1 and 3 covering the sequence, pass 3's
    64-row tiles covering the chunk, pass 2's threads one per state
    element; pass 1's ring (two 32-row stages of B and x) and pass 3's
    buffers (the entering state, two stages of C_T, B_T padded and x_T,
    the scores) within a block's 232,448 bytes, three and one blocks an SM
    with their static arrays (3 KB and 2.25 KB) and 1 KB reserved a
    block; at 4 x 4096 4,096 blocks a pass and two f32
    state scratches of 134 MB."""
    for chunk in range(1, 257):
        lay = ssd_launcher.ffma_layout(2, 3 * chunk, 4, 64, 128, chunk)
        assert lay["chunks"] == 3
        assert lay["pass1_grid"] == lay["pass3_grid"] == (3, 4, 2)
        tiles = lay["pass3_row_tiles"]
        assert (tiles - 1) * 64 < chunk <= tiles * 64
        gx, gy = lay["pass2_grid"]
        assert (gx - 1) * 256 < 128 * 64 <= gx * 256 and gy == 8
        assert (lay["pass1_threads"], lay["pass3_threads"]) == (128, 256)
        for smem, static, blocks in ((lay["pass1_smem_bytes"], 3072, 3),
                                     (lay["pass3_smem_bytes"], 2304, 1)):
            assert smem <= 232448
            assert blocks * (smem + static + 1024) <= 233472
    assert ssd_launcher.ffma_layout(1, 512, 4, 16, 16, 256)[
        "pass3_smem_bytes"] == 4 * (128 * 64 + 2 * (64 * 128 + 64 * 132
                                                    + 64 * 64) + 64 * 68)
    lay = ssd_launcher.ffma_layout(4, 4096, 64, 64, 128, 256)
    assert math.prod(lay["pass1_grid"]) == math.prod(lay["pass3_grid"]) \
        == 4096
    states = 4 * 64 * 16 * 128 * 64
    assert 4 * states == 134217728
    assert lay["scratch_bytes"] == 8 * states + 4 * 4 * 64 * 4096 \
        + 4 * 4 * 64 * 16
    for s, chunk in ((100, 64), (512, 512)):
        with pytest.raises(ValueError, match="chunk"):
            ssd_launcher.ffma_layout(1, s, 4, 16, 16, chunk)


def _cpu(b=1, s=64, h=4, p=16, g=2, n=16, dtype=torch.bfloat16):
    x, dt, a, bm, cm = (torch.as_tensor(v)
                        for v in _operands(4, b, s, h, p, g, n))
    return [x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_is_fixed_by_dtype(monkeypatch, dtype):
    """bf16 reaches the tensor-core library, f32 the FFMA one, each with its
    four scratch tensors (the entering states in x's dtype); every call
    counts in ``ssd_launches``, tensor-core
    calls in ``ssd_tc_launches`` (launch recorded in place of the kernel,
    the device check bypassed)."""
    calls = []
    monkeypatch.setattr(ssd_launcher.build, "cuda_device",
                        lambda kernel, t: t.device)
    monkeypatch.setattr(ssd_launcher.build, "launch",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(ssd_launcher, "ssd_launches", 0)
    monkeypatch.setattr(ssd_launcher, "ssd_tc_launches", 0)
    args = _cpu(s=96, dtype=dtype)
    y = ssd_launcher.ssd_scan(*args, chunk=64)
    assert y.dtype == dtype and y.shape == args[0].shape
    (kernel, lib, symbol, tensors, scalars, _, errors), = calls
    tc = dtype == torch.bfloat16
    assert lib == (ssd_launcher.TC_LIB if tc else ssd_launcher.LIB)
    assert symbol == ("ssd_scan_bf16" if tc else "ssd_scan_f32")
    assert errors.startswith(lib)
    assert scalars == [1, 96, 4, 16, 2, 16, 32]     # the chunk halves to 32
    assert tensors[5] is y and len(tensors) == 10
    states, entering, cum, decay = tensors[6:]
    assert (states.shape, states.dtype) == ((1, 4, 3, 16, 16),
                                            torch.float32)
    assert (entering.shape, entering.dtype) == ((1, 4, 3, 16, 16), dtype)
    assert tuple(cum.shape) == (1, 4, 96) and tuple(decay.shape) == (
        1, 4, 3)
    assert all(t.is_contiguous() for t in tensors)
    assert (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches) == (
        1, int(tc))


REFUSALS = {   # mutation of (x, dt, a, bm, cm) -> error, message
    "x 3-D": (lambda a: [a[0][0]] + a[1:], ValueError, "expected x"),
    "x f16": (lambda a: [a[0].half()] + a[1:], TypeError, "dtype"),
    "b f32 beside bf16 x": (lambda a: a[:3] + [a[3].float(), a[4]],
                            TypeError, "dtype"),
    "dt bf16": (lambda a: [a[0], a[1].bfloat16()] + a[2:], TypeError,
                "dtype"),
    "a other heads": (lambda a: a[:2] + [a[2][:3].contiguous()] + a[3:],
                      ValueError, "shape"),
    "c other length": (lambda a: a[:4] + [a[4][:, :8].contiguous()],
                       ValueError, "shape"),
    "x not contiguous": (lambda a: [a[0].transpose(1, 2).contiguous()
                                    .transpose(1, 2)] + a[1:], ValueError,
                         "contiguous"),
    "groups do not divide": (lambda a: _cpu(h=3, g=2), ValueError,
                             "shape|groups"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_launcher_refuses_bad_operands_on_the_host(case):
    """Every operand check of the SSD launcher, on the CPU through
    ``check_operands`` (the launcher calls it with the CUDA device)."""
    cpu = torch.device("cpu")
    args = _cpu()
    assert ssd_launcher.check_operands(*args, cpu) == (1, 64, 4, 16, 2, 16)
    mutate, error, message = REFUSALS[case]
    with pytest.raises(error, match=message):
        ssd_launcher.check_operands(*mutate(args), cpu)


def test_launcher_refuses_cpu_tensors():
    before = (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_launcher.ssd_scan(*_cpu(), chunk=32)
    assert (ssd_launcher.ssd_launches, ssd_launcher.ssd_tc_launches) \
        == before


def test_chunked_scan_gradient_stays_finite_past_the_decay_overflow():
    """Where a chunk's Σ dt·|a| passes ~88, exp(cum_t − cum_u) above the
    diagonal overflows.  The reference masks only the decay after exp, so
    its gradient is NaN there (inf times the mask's zero); the port masks
    the exponent too: the same forward bits' worth of values (within 1e-6
    of the reference's) and a finite gradient."""
    import jax

    from repro.models import ssm as jssm
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(0)
    b, s, h, p, g, n, chunk = 1, 64, 2, 4, 1, 8, 32
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    dt = np.full((b, s, h), 3.0, np.float32)        # 32 · 3 · 2 = 192 > 88
    a = np.array([-2.0, -1.0], np.float32)

    def jloss(dt_):
        return jssm.ssd_chunked(jnp.asarray(x), dt_, jnp.asarray(a),
                                jnp.asarray(bm), jnp.asarray(cm),
                                chunk)[0].sum()
    j_y = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                           jnp.asarray(bm), jnp.asarray(cm), chunk)[0]
    assert not np.isfinite(np.asarray(jax.grad(jloss)(jnp.asarray(dt)))).all()
    t_dt = torch.tensor(dt, requires_grad=True)
    t_y, _ = ssd_chunked(torch.tensor(x), t_dt, torch.tensor(a),
                         torch.tensor(bm), torch.tensor(cm), chunk)
    t_y.sum().backward()
    assert bool(torch.isfinite(t_dt.grad).all())
    want = np.asarray(j_y)
    assert float(np.abs(t_y.detach().numpy() - want).max()) <= \
        1e-6 * float(np.abs(want).max())
