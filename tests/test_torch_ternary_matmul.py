"""The port's ternary matmul (K3): its plain version and the dispatch of
`repro_torch.kernels.ops.ternary_matmul` against the JAX package's Pallas
kernel (interpret mode) and oracle, the ideal digital reference
`ideal_ternary_matmul`, the shared nvcc build step, and — on a machine with
a card — the CUDA kernel against its plain version.

Same numpy inputs on both sides.  With {0,1} inputs every partial sum is an
integer below 2^24, so any float32 summation order gives the same bits:
bit-exact.  Normal inputs: rtol 1e-6, atol 1e-4 (float32 sums in another
order); bfloat16 inputs: 3e-2, the JAX package's own kernel tolerance.

The CUDA kernel runs on the tensor cores: it splits float32 x into three
bfloat16 parts by truncation (`ref.bf16x3_split_masked`, held here on edge
values, non-finite values and every float32 bit pattern), multiplies each
part by the weights widened to bfloat16, adds each stage's 12 tensor-core
products into a stage accumulator that it promotes into a float32
register accumulator, and sums a split over K in rank order.  A float64
emulation of that arithmetic, with the tensor cores' additions rounded to
nearest or truncated (the worse case), is held against the Pallas kernel
and the oracle at the chip smoke run's tolerances (rtol 1e-5, atol 1e-4);
one accumulator through all of K instead breaks them when it truncates.
`ternary_matmul.plan`, the launch geometry (load path, split over K,
grid), is held at the shapes the kernel is timed at and over a sweep of
shapes for its invariants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:             # hypothesis optional: the sweeps then skip
    def given(*_a, **_k):
        return lambda f: pytest.mark.skip(
            reason="hypothesis not installed")(f)

    def settings(*_a, **_k):
        return lambda f: f

    class _NoStrategies:
        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _NoStrategies()

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import crossbar as tcb  # noqa: E402
from repro_torch.kernels import build as nvb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ternary_matmul as kern3  # noqa: E402
from torch_smoke_loader import chip_smoke  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(1, 16, 1), (33, 300, 77), (200, 1000, 40)]


def _case(seed, B, K, N, kind):
    rng = np.random.default_rng(seed)
    if kind == "bits":
        x = (rng.random((B, K)) < 0.5).astype(np.float32)
    else:
        x = rng.standard_normal((B, K)).astype(np.float32)
    w = rng.integers(-1, 2, size=(K, N)).astype(np.int8)
    return x, w


def _jax_pallas(x, w, bf16):
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    return np.asarray(jops.ternary_matmul(xj, jnp.asarray(w), interpret=True))


@pytest.mark.parametrize("kind", ["bits", "normal", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_pallas_and_oracle(shape, kind):
    x, w = _case(sum(shape), *shape, kind)
    bf16 = kind == "bf16"
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    ops.reset_launches()
    got = ops.ternary_matmul(xt, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    assert ops.LAUNCHES["ternary_matmul"] == 0           # CPU: plain version
    torch.testing.assert_close(got, tref.ternary_matmul_ref(xt, torch.from_numpy(w)),
                               rtol=0, atol=0)
    pallas = _jax_pallas(x, w, bf16)
    oracle = np.asarray(jref.ternary_matmul_ref(
        jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32),
        jnp.asarray(w)))
    for want in (pallas, oracle):
        if kind == "bits":
            np.testing.assert_array_equal(got.numpy(), want)
        elif kind == "normal":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-4)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=3e-2,
                                       atol=3e-2)


def test_ideal_ternary_matmul_matches_reference():
    from repro.core.crossbar import ideal_ternary_matmul as jideal
    rng = np.random.default_rng(11)
    x = (rng.random((64, 540)) < 0.5).astype(np.float32)
    w = rng.integers(-1, 2, size=(540, 60)).astype(np.float32)
    np.testing.assert_array_equal(
        tcb.ideal_ternary_matmul(torch.from_numpy(x),
                                 torch.from_numpy(w)).numpy(),
        np.asarray(jideal(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("bad", [2.0, 0.5, -3.0, float("nan")])
def test_ideal_ternary_matmul_refuses_non_ternary_weights(bad):
    w = torch.zeros((8, 3))
    w[4, 1] = bad
    with pytest.raises(ValueError, match="-1, 0, \\+1"):
        tcb.ideal_ternary_matmul(torch.ones((2, 8)), w)


def test_checks_raise():
    x = torch.ones((4, 8))
    w = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="x \\[B,K\\]"):
        ops.ternary_matmul(x[:, :-1], w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.ternary_matmul(x.double(), w)
    with pytest.raises(ValueError, match="int8"):
        ops.ternary_matmul(x, w.float())


def test_cuda_request_raises_when_kernel_cannot_load(monkeypatch):
    """A CUDA operand never reaches the plain version: if the kernel cannot
    be built or loaded the call raises and counts nothing."""
    def no_kernel():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ops, "_check_ternary",
                        lambda *a: torch.device("cuda"))
    monkeypatch.setattr(kern3, "load", no_kernel)
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.ternary_matmul(torch.ones((2, 4)),
                           torch.ones((4, 3), dtype=torch.int8))
    assert ops.LAUNCHES["ternary_matmul"] == 0


def _fake_nvcc(tmp_path, log):
    """A stand-in `$CUDA_HOME/bin/nvcc` that records its call and writes
    the `-o` file."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
        "  shift\n"
        "done\n"
        "echo 'ptxas info : Used 40 registers' >&2\n")
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_compiles_each_stale_source_once(monkeypatch, tmp_path):
    """One library per source; a library newer than its source is kept, a
    stale one is rebuilt; every nvcc call targets sm_90a."""
    import os
    log = tmp_path / "calls.log"
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, log)))
    monkeypatch.setattr(nvb, "build_dir", lambda: tmp_path / "build")
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for s in srcs:
        s.write_text("// kernel\n")
    libs = nvb.build(*srcs)
    assert [p.name for p in libs] == ["liba.so", "libb.so"]
    assert all(p.is_file() for p in libs)
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and all("code=sm_90a" in c for c in calls)
    assert "Used 40 registers" in nvb.BUILD_LOG["a.cu"]
    nvb.build(*srcs)
    assert len(log.read_text().splitlines()) == 2        # up to date
    assert nvb.BUILD_S["a.cu"] == 0.0
    future = libs[1].stat().st_mtime + 10
    os.utime(srcs[1], (future, future))
    nvb.build(*srcs)
    calls = log.read_text().splitlines()
    assert len(calls) == 3 and calls[-1].endswith("b.cu")


def test_both_kernels_build_from_csrc():
    assert kern3.SOURCE.is_file() and kern3.SOURCE.parent == nvb.CSRC
    assert nvb.library_path(kern3.SOURCE).name == "libternary_matmul.so"


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bits", "normal", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(cuda_device, shape, kind):
    x, w = _case(sum(shape), *shape, kind)
    xt = torch.from_numpy(x).to(cuda_device)
    if kind == "bf16":
        xt = xt.to(torch.bfloat16)
    wt = torch.from_numpy(w).to(cuda_device)
    ops.reset_launches()
    got = ops.ternary_matmul(xt, wt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ternary_matmul"] == 1
    want = tref.ternary_matmul_ref(xt, wt)
    if kind == "bits":
        assert torch.equal(got, want)
    elif kind == "normal":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------- the split

FLT_MAX = float(np.finfo(np.float32).max)
F32_ONE_DOWN = float(np.nextafter(np.float32(1), np.float32(0)))
MASKED_EDGES = [0.0, 1.0, 0.5, 2.0 ** -24, 2.0 ** -126, F32_ONE_DOWN,
                1 - 2.0 ** -9, 1 + 2.0 ** -23, float(np.float32(1 / 3)),
                float(np.float32(0.1)), 2.0 ** -110 * (2 - 2.0 ** -23),
                3.0e38, FLT_MAX, float(np.nextafter(np.float32(FLT_MAX),
                                                    np.float32(0)))]


def _f32(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


def _assert_masked_exact(x):
    hi, mid, lo = tref.bf16x3_split_masked(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.isfinite(hi).all()
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # hi is x's top 16 bits, truncated
    bits = x.numpy().view(np.uint32)
    assert np.array_equal(hi.float().numpy().view(np.uint32),
                          bits & np.uint32(0xFFFF0000))


@pytest.mark.parametrize("v", MASKED_EDGES, ids=lambda v: f"{v:.9g}")
def test_bf16x3_split_masked_edges(v):
    """+-0, powers of two, values with all 24 bits set, 2^-110, and values
    near FLT_MAX (where the rounded split's hi would overflow to Inf):
    hi + mid + lo == x exactly, hi finite."""
    _assert_masked_exact(torch.tensor([v, -v], dtype=torch.float32))


def test_bf16x3_split_masked_keeps_signed_zero():
    hi, mid, lo = tref.bf16x3_split_masked(torch.tensor([-0.0, 0.0]))
    assert torch.equal(torch.signbit(hi), torch.tensor([True, False]))
    assert not mid.any() and not lo.any()


@pytest.mark.parametrize("bits", [0x7F800000, 0xFF800000, 0x7FC00000,
                                  0xFFC00000, 0x7F800001, 0x7FFFFFFF],
                         ids=["+inf", "-inf", "nan", "-nan", "nan-low",
                              "nan-all"])
def test_bf16x3_split_masked_non_finite(bits):
    """An Inf or NaN stays in hi (a NaN as a NaN, also one whose payload
    lies in its low 16 bits, which truncation alone would turn into Inf),
    with mid = lo = 0: x * 1 and x * 0 over the parts give what an f32
    product gives."""
    x = _f32([bits])
    hi, mid, lo = (t.float() for t in tref.bf16x3_split_masked(x))
    assert not mid.any() and not lo.any()
    assert torch.equal(torch.isnan(hi), torch.isnan(x))
    assert torch.equal(torch.isinf(hi), torch.isinf(x))
    for wv in (1.0, -1.0, 0.0):
        got = hi * wv + mid * wv + lo * wv
        want = x * wv
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])


@pytest.mark.parametrize("v", [2.0 ** -149, 2.0 ** -133, 3.0e-39,
                               2.0 ** -126 - 2.0 ** -149, 2.0 ** -111])
def test_bf16x3_split_masked_below_2e_110(v):
    """Below 2^-110 (subnormals too) lo keeps only multiples of bf16's
    smallest subnormal step, 2^-133: hi + mid + lo is within 2^-133 of x
    and exact where x is such a multiple."""
    x = torch.tensor([v, -v], dtype=torch.float32)
    hi, mid, lo = tref.bf16x3_split_masked(x)
    err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert float(err.max()) < 2.0 ** -133
    if float(x[0]) % 2.0 ** -133 == 0:
        assert float(err.max()) == 0.0


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=2 ** 32 - 1),
                min_size=1, max_size=64))
def test_bf16x3_split_masked_every_bit_pattern(words):
    """Any float32 bit pattern: exact where |x| >= 2^-110, within 2^-133
    below, and non-finite values carried by hi alone."""
    x = _f32(words)
    hi, mid, lo = (t.double() for t in tref.bf16x3_split_masked(x))
    fin = torch.isfinite(x)
    assert torch.equal(torch.isnan(hi), torch.isnan(x))
    assert torch.equal(torch.isinf(hi), torch.isinf(x))
    assert not mid[~fin].any() and not lo[~fin].any()
    err = (hi + mid + lo - x.double())[fin].abs()
    big = x[fin].abs() >= 2.0 ** -110
    assert not err[big].any()
    assert bool((err < 2.0 ** -133).all())


# ------------------------------------------------ the kernel's arithmetic

#: clusters of each size that an NVIDIA H100 80GB HBM3 holds at once for
#: this kernel (cudaOccupancyMaxActiveClusters, as `chip_smoke.py`'s card
#: reported it), and its SM count
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
H100_SMS = 132


def _h100_plan(B, K, N, bf16=False, x_ptr=0):
    return kern3.plan(B, K, N, bf16, x_ptr, H100_SMS,
                      lambda split, kw: H100_CLUSTERS[split])


def _to_f32(v64, mode):
    """float64 -> float32, rounded to nearest ("rn") or truncated ("rz")."""
    r = v64.float()
    if mode == "rz":
        over = r.double().abs() > v64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _emulate_kernel(x, w, split, k_slice, tc="rz", promote=True):
    """csrc/ternary_matmul.cu's arithmetic on the CPU.  x [B,K] float32
    (split by `bf16x3_split_masked`) or bfloat16 (one part); w [K,N] int8.
    Block r of the cluster covers K from r * k_slice in stages of 64: per
    stage, each k16 step's hi pass, then its mid and lo passes, each adding
    16 exact products into the stage accumulator with one rounding `tc`
    (the tensor cores' f32 adds: to nearest, or truncated); the stage
    accumulator then goes into the block's float32 accumulator, rounded to
    nearest.  The blocks' tiles are summed in rank order.  With `promote`
    off, one accumulator runs through the block's whole K range."""
    if x.dtype == torch.bfloat16:
        parts = [x.float()]
    else:
        parts = [t.float() for t in tref.bf16x3_split_masked(x)]
    wf = w.double()
    B, K = x.shape
    N = w.shape[1]
    steps = ([(kk, 0) for kk in range(4)]
             + [(kk, p) for kk in range(4) for p in range(1, len(parts))])
    out = None
    for r in range(split):
        acc = torch.zeros((B, N))
        d = torch.zeros((B, N))
        k_end = min(K, (r + 1) * k_slice)
        for s0 in range(r * k_slice, k_end, 64):
            if promote:
                d = torch.zeros((B, N))
            for kk, part in steps:
                a = s0 + 16 * kk
                if a < k_end:
                    d = _to_f32(d.double() + parts[part][:, a:a + 16].double()
                                @ wf[a:a + 16], tc)
            if promote:
                acc = acc + d
        tile = acc if promote else d
        out = tile if out is None else out + tile
    return out


EMU_SHAPES = [(1, 16, 1), (33, 300, 77), (200, 1000, 40), (256, 540, 60),
              (8, 2048, 16)]


@pytest.mark.parametrize("kind", ["bits", "normal", "bf16"])
@pytest.mark.parametrize("shape", EMU_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_emulation_matches_pallas_and_oracle(shape, kind):
    """The emulation at the H100 plan's split (5 at 33x300x77, 8 at
    200x1000x40, 5 at the layer's 256x540x60, 8 at 8x2048x16) and without a
    split, with the tensor cores' adds rounded to nearest and truncated:
    {0,1} x bit-exact against the Pallas kernel and the oracle; normal and
    bfloat16 x (both sides compute in f32 on the same values) within rtol
    1e-5, atol 1e-4."""
    B, K, N = shape
    x, w = _case(sum(shape) + 1, B, K, N, kind)
    xt = torch.from_numpy(x)
    if kind == "bf16":
        xt = xt.to(torch.bfloat16)
    jx = np.asarray(xt.float().numpy())
    pallas = _jax_pallas(jx, w, kind == "bf16")
    oracle = np.asarray(jref.ternary_matmul_ref(
        jnp.asarray(jx, jnp.bfloat16 if kind == "bf16" else jnp.float32),
        jnp.asarray(w)))
    pl = _h100_plan(B, K, N, kind == "bf16")
    for split, k_slice in {(pl.split, pl.k_slice), (1, pl.k_slice *
                                                   pl.split)}:
        for tc in ("rz", "rn"):
            got = _emulate_kernel(xt, torch.from_numpy(w), split, k_slice,
                                  tc).numpy()
            for want in (pallas, oracle):
                if kind == "bits":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-4)


@pytest.mark.parametrize("shape", [(64, 2048, 32), (256, 2048, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_promotion_keeps_a_truncating_accumulator_in_tolerance(shape):
    """At kernel_bench's depth, K = 2048, without a split: if the tensor
    cores truncate their f32 adds, one accumulator through K drifts past
    rtol 1e-5 / atol 1e-4 of the plain version (7e-4 to 1e-3 here), and
    promoting the stage accumulator into a round-to-nearest accumulator
    after every stage keeps it within (6e-5 to 8e-5)."""
    B, K, N = shape
    x, w = _case(7, B, K, N, "normal")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = tref.ternary_matmul_ref(xt, wt)
    kept = _emulate_kernel(xt, wt, 1, 2048, "rz", promote=True)
    drift = _emulate_kernel(xt, wt, 1, 2048, "rz", promote=False)
    torch.testing.assert_close(kept, plain, rtol=1e-5, atol=1e-4)
    assert not torch.allclose(drift, plain, rtol=1e-5, atol=1e-4)
    assert float((kept - plain).abs().max()) < \
        float((drift - plain).abs().max()) / 5


# --------------------------------------------------------- launch geometry

@pytest.mark.parametrize("B,K,N,bf16,x_ptr,path", [
    (256, 540, 60, False, 0, "tma"),          # the layer path
    (294_912, 540, 60, False, 256, "tma"),    # s0
    (65, 301, 60, False, 0, "cp.async"),      # K * 4 not a multiple of 16
    (300, 540, 60, False, 4, "cp.async"),     # base 4 bytes off
    (256, 540, 60, True, 0, "cp.async"),      # bf16 rows of 1,080 bytes
    (256, 2048, 512, True, 0, "tma"),
    (256, 2048, 512, True, 4, "cp.async"),
    (65, 301, 60, True, 0, "ld.global"),      # odd K: rows 2 bytes off
    (300, 540, 60, True, 2, "ld.global"),     # base 2 bytes off
], ids=lambda v: str(v))
def test_plan_load_path(B, K, N, bf16, x_ptr, path):
    assert _h100_plan(B, K, N, bf16, x_ptr).path == path


@pytest.mark.parametrize("shape,split,k_slice,kw,clusters", [
    ((256, 540, 60), 5, 128, 128, 2),          # layer: 2 tiles, K in 5
    ((256, 2048, 512), 6, 384, 384, 16),       # kernel_bench: 16 tiles
    ((294_912, 540, 60), 1, 576, 576, 132),    # s0: persistent, 2,304 tiles
    ((40_000, 1000, 70), 1, 1024, 768, 132),   # K range loaded in chunks
    ((33, 300, 77), 5, 64, 64, 2),
    ((300, 2048, 130), 8, 256, 256, 9),
    ((1, 16, 1), 1, 64, 64, 1),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plan_split_and_grid(shape, split, k_slice, kw, clusters):
    """The H100 plans of the timed and checked shapes.  kernel_bench's 16
    tiles take clusters of 6: clusters of 7 or 8 would not all fit on the
    card at once (15 do)."""
    pl = _h100_plan(*shape)
    assert (pl.split, pl.k_slice, pl.kw, pl.clusters) == (
        split, k_slice, kw, clusters)
    assert pl.grid == clusters * split


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 400_000), st.integers(1, 20_000),
       st.integers(1, 1024), st.booleans(), st.sampled_from([0, 2, 4, 8]))
def test_plan_invariants(B, K, N, bf16, x_ptr):
    """Every plan: the blocks' K ranges are multiples of 64, cover K, and
    none is empty; at most 8 blocks a cluster, and with a split one tile a
    cluster, all clusters on the card at once; the weights resident at once
    are a multiple of 64 rows no deeper than the range; the shared memory
    fits a block."""
    pl = _h100_plan(B, K, N, bf16, x_ptr)
    items = pl.tiles_m * pl.tiles_n
    assert pl.tiles_m * kern3.TILE_M >= B > (pl.tiles_m - 1) * kern3.TILE_M
    assert pl.tiles_n * kern3.TILE_N >= N > (pl.tiles_n - 1) * kern3.TILE_N
    assert pl.k_slice % kern3.STAGE_K == 0
    assert (pl.split - 1) * pl.k_slice < K <= pl.split * pl.k_slice
    assert 1 <= pl.split <= kern3.MAX_SPLIT
    assert 1 <= pl.clusters <= items
    if pl.split > 1:
        assert pl.clusters == items <= H100_CLUSTERS[pl.split]
        assert 2 * items <= H100_SMS
    assert pl.kw % kern3.STAGE_K == 0 and kern3.STAGE_K <= pl.kw <= pl.k_slice
    assert kern3.smem_bytes(bf16, pl.kw, pl.split) <= kern3.SMEM_MAX


def test_smem_bytes_at_s0():
    """1 KB of alignment, a ring of 4 x 32 KB, 576 weight rows x 128 bytes,
    9 mbarriers; a split adds the partial tiles' room, 136 x 288 bytes."""
    assert kern3.smem_bytes(False, 576, 1) == 1024 + 131_072 + 73_728 + 72
    assert kern3.smem_bytes(True, 128, 5) == 1024 + 65_536 + 16_384 + \
        39_168 + 72


@pytest.mark.parametrize("shape,x_bytes,want_ms,by", [
    ((256, 540, 60), 4, 0.000193075, "bytes"),
    ((256, 2048, 512), 4, 0.001628665, "operations"),
    ((294_912, 540, 60), 4, 0.211290, "bytes"),
    ((256, 2048, 512), 2, 0.000782458, "bytes"),
], ids=["layer", "kernel_bench", "s0", "kernel_bench-bf16"])
def test_k3_bound(shape, x_bytes, want_ms, by):
    """`chip_smoke.k3_bound_ms`: f32 x at three bf16 tensor-core passes
    (3 x 2BKN at 989 TFLOP/s), bf16 x at one, against x, the int8 weights
    and the f32 output moved once at 3.35 TB/s."""
    ms, got_by = chip_smoke().k3_bound_ms(*shape, x_bytes)
    assert got_by == by
    assert ms == pytest.approx(want_ms, rel=1e-4)
