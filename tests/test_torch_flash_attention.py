"""The port's causal flash attention (K4) against the JAX package.

`repro_torch.kernels.flash_attention` (the op: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors) and `flash_attention_ref` are
held against the reference's op `repro.kernels.flash_attention` (its
Pallas kernel in interpret mode here) and its oracle `flash_attention_ref`,
on the same numpy inputs, at the shapes of `tests/test_kernels.py::
TestFlashAttention`.  Tolerances are that file's: atol 2e-5 and rtol 1e-4
in float32 (the kernel's online softmax against one softmax over all
keys), 3e-2 in bfloat16 (one bf16 rounding of the output).  The CUDA leg
runs on the card only.

The bfloat16 kernel splits its float32 softmax weights p into three
bfloat16 parts and runs P V as three tensor-core passes.  The split
(`bf16x3_split`, exact) and a float32 emulation of the kernel's algorithm
are held here: three passes keep the reference's precision, one pass (p
rounded to bfloat16) breaks the row-scaled bound that `chip_smoke.py`
holds the kernel to.

The float32 kernel splits q, k, v and p by truncation into three bfloat16
parts each (`bf16x3_split_masked`) and keeps six of the nine products of
parts for QK^T and for P V (bf16x6).  An emulation of its arithmetic
(`_emulate_f32_kernel`) is held here against the JAX op and the plain
version at F32, and fewer terms are shown to break F32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:             # hypothesis optional: the sweep then skips
    def given(*_a, **_k):
        return lambda f: pytest.mark.skip(
            reason="hypothesis not installed")(f)

    def settings(*_a, **_k):
        return lambda f: f

    class _NoStrategies:
        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _NoStrategies()

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_ref)
from repro_torch.kernels.ref import (bf16x3_split,  # noqa: E402
                                    bf16x3_split_masked)
from torch_smoke_loader import chip_smoke  # noqa: E402

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
# (H, S, hd, reference bq, reference bk): tests/test_kernels.py's shapes
SHAPES = [(2, 64, 16, 16, 16), (4, 128, 32, 32, 64), (1, 100, 16, 32, 32),
          (2, 256, 64, 128, 128)]


def _qkv(H, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H, Sq, hd)).astype(np.float32),
            rng.standard_normal((H, Sk, hd)).astype(np.float32),
            rng.standard_normal((H, Sk, hd)).astype(np.float32))


def _jax(q, k, v, bq, bk, dtype=jnp.float32):
    from repro.kernels import flash_attention as jflash
    from repro.kernels import flash_attention_ref as jref
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return (np.asarray(jflash(*args, bq=bq, bk=bk), np.float32),
            np.asarray(jref(*args), np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}x{s[2]}")
def test_op_matches_reference(shape):
    H, S, hd, bq, bk = shape
    q, k, v = _qkv(H, S, S, hd, S)
    j_op, j_ref = _jax(q, k, v, bq, bk)
    T = torch.from_numpy
    out = flash_attention(T(q), T(k), T(v))
    plain = flash_attention_ref(T(q), T(k), T(v))
    assert out.dtype == torch.float32 and out.shape == (H, S, hd)
    np.testing.assert_allclose(out.numpy(), j_op, **F32)
    np.testing.assert_allclose(plain.numpy(), j_ref, **F32)
    np.testing.assert_allclose(plain.numpy(), j_op, **F32)


def test_bf16_matches_reference():
    q, k, v = _qkv(2, 128, 128, 32, 0)
    j_op, j_ref = _jax(q, k, v, 64, 64, jnp.bfloat16)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    out = flash_attention(bf(q), bf(k), bf(v))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), j_op, **BF16)
    np.testing.assert_allclose(out.float().numpy(), j_ref, **BF16)


@pytest.mark.parametrize("Sq,Sk,bq,bk", [(64, 40, 32, 32), (96, 40, 32, 16),
                                         (40, 64, 32, 32)])
def test_ragged_sq_sk_follow_the_oracle(Sq, Sk, bq, bk):
    """Sq != Sk with Sk not a multiple of the key tile.  The reference's
    wrapper then takes the whole of Sk as its key tile (its `bk_`), so it
    pads no zero keys and agrees with the oracle; the port masks keys past
    Sk inside the kernel and agrees with both."""
    q, k, v = _qkv(2, Sq, Sk, 16, Sq + Sk)
    j_op, j_ref = _jax(q, k, v, bq, bk)
    np.testing.assert_allclose(j_op, j_ref, **F32)
    T = torch.from_numpy
    np.testing.assert_allclose(flash_attention(T(q), T(k), T(v)).numpy(),
                               j_ref, **F32)


@settings(max_examples=8, deadline=None)
@given(H=st.integers(1, 4), S=st.sampled_from([32, 64, 96, 160]),
       hd=st.sampled_from([16, 32]), seed=st.integers(0, 2**16))
def test_property_matches_reference(H, S, hd, seed):
    q, k, v = _qkv(H, S, S, hd, seed)
    j_op, _ = _jax(q, k, v, 32, 32)
    T = torch.from_numpy
    np.testing.assert_allclose(flash_attention(T(q), T(k), T(v)).numpy(),
                               j_op, **F32)


def test_checks_and_launch_counter():
    """CPU calls take the plain version and count no launch; misuse
    raises."""
    q = torch.zeros(1, 8, 16)
    ops.reset_launches()
    flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros(1, 8, 24), torch.zeros(1, 8, 24),
                        torch.zeros(1, 8, 24))
    with pytest.raises(ValueError, match="bq and bk"):
        flash_attention(q, q, q, bq=128)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q, q.bfloat16(), q)


def test_package_attribute_stays_the_op():
    """`repro_torch.kernels.flash_attention` is the op before and after its
    first calls: loading the CUDA binding (a module of another name) must
    not rebind the package's attribute."""
    import repro_torch.kernels as K
    from repro_torch.kernels import flash_attention_cuda
    q = torch.from_numpy(_qkv(1, 16, 16, 16, 3)[0])
    first = K.flash_attention(q, q, q)
    second = K.flash_attention(q, q, q)
    assert K.flash_attention is ops.flash_attention
    assert torch.equal(first, second)
    assert flash_attention_cuda.SOURCE.name == "flash_attention.cu"


def _assert_split_exact(p):
    hi, mid, lo = bf16x3_split(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), p)
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())


F32_ONE_DOWN = float(np.nextafter(np.float32(1), np.float32(0)))
SPLIT_EDGES = [0.0, 1.0, 0.5, 2.0 ** -24, 2.0 ** -126, F32_ONE_DOWN,
               1 - 2.0 ** -9, 1 - 2.0 ** -17, 1 + 2.0 ** -23,
               float(np.float32(1 / 3)), float(np.float32(0.1)),
               2.0 ** -110 * (2 - 2.0 ** -23)]


@pytest.mark.parametrize("p", SPLIT_EDGES, ids=lambda p: f"{p:.9g}")
def test_bf16x3_split_edges(p):
    """Zero, powers of two (2^-126, the smallest normal, too), values just
    under and over 1 and ones with all 24 bits set, down to 2^-110: hi +
    mid + lo == p exactly."""
    _assert_split_exact(torch.tensor([p, -p], dtype=torch.float32))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(min_value=2.0 ** -110, max_value=1.0, width=32),
                min_size=1, max_size=64))
def test_bf16x3_split_is_exact(ps):
    """Every float32 in [2^-110, 1], softmax weights down to 2^-110 of
    their row's largest."""
    _assert_split_exact(torch.tensor(ps, dtype=torch.float32))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(min_value=2.0 ** -126, max_value=2.0 ** -110,
                          width=32), min_size=1, max_size=64))
def test_bf16x3_split_below_2e_110_errs_at_most_2e_134(ps):
    """Below 2^-110 the last part meets bf16's smallest subnormal step
    (2^-133) and rounds: hi + mid + lo is within 2^-134 of p."""
    p = torch.tensor(ps, dtype=torch.float32)
    hi, mid, lo = bf16x3_split(p)
    err = (hi.double() + mid.double() + lo.double() - p.double()).abs()
    assert float(err.max()) <= 2.0 ** -134


def _emulate_bf16_kernel(q, k, v, passes, bk=64):
    """The bf16 kernel's algorithm in float32 on the CPU: key tiles of
    `bk`, online softmax with float32 max and denominator, P V as
    `passes` products of bfloat16 parts of p (3: `bf16x3_split`; 1: p
    rounded to bfloat16) summed in float32.  Returns the float32 output
    before its one rounding to bfloat16."""
    H, Sq, hd = q.shape
    Sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((H, Sq, 1), float("-inf"))
    l = torch.zeros(H, Sq, 1)
    acc = torch.zeros(H, Sq, hd)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        s = (qf @ kt.transpose(1, 2)) * hd ** -0.5
        keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
        s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        parts = bf16x3_split(p) if passes == 3 else (p.bfloat16(),)
        pv = parts[0].float() @ vt
        for part in parts[1:]:
            pv = pv + part.float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return acc / l.clamp_min(1e-20)


def _row_ratio(got, q, k, v):
    """chip_smoke.py's `bf16_row_ratio`: the worst ratio of the bf16
    output's error, against the plain version in float32 on the same
    inputs, to one bf16 rounding of the output (2^-8 of it) plus 1e-4 of
    its row's largest output."""
    want = flash_attention_ref(q.float(), k.float(), v.float())
    row = want.abs().amax(-1, keepdim=True)
    bound = 2.0 ** -8 * want.abs() + 1e-4 * row
    return float(((got.float() - want).abs() / bound).max())


@pytest.fixture(scope="module")
def precision_case():
    """H=2, S=1024, hd=128, bf16 inputs (and their float32 values)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 1024, 1024, 128, 1024))
    return q, k, v


def test_three_pass_split_keeps_f32_precision(precision_case):
    """Three passes on the split of p: the float32 output meets the F32
    tolerance against the plain version and the JAX op in float32, and
    the bf16 output meets the BF16 tolerance against the JAX op in
    bfloat16 and the row-scaled bound."""
    q, k, v = precision_case
    out32 = _emulate_bf16_kernel(q, k, v, passes=3)
    np.testing.assert_allclose(
        out32.numpy(),
        flash_attention_ref(q.float(), k.float(), v.float()).numpy(), **F32)
    qn, kn, vn = (t.float().numpy() for t in (q, k, v))
    j_op32, _ = _jax(qn, kn, vn, 256, 256)
    np.testing.assert_allclose(out32.numpy(), j_op32, **F32)
    out = out32.bfloat16()
    j_op, j_ref = _jax(qn, kn, vn, 256, 256, jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), j_op, **BF16)
    np.testing.assert_allclose(out.float().numpy(), j_ref, **BF16)
    assert _row_ratio(out, q, k, v) <= 1.0


def test_single_bf16_pass_breaks_the_row_bound(precision_case):
    """p rounded once to bfloat16 (one pass, as sdpa does): late rows
    average ~1,000 values, and p's rounding error outgrows the bound."""
    q, k, v = precision_case
    out = _emulate_bf16_kernel(q, k, v, passes=1).bfloat16()
    assert _row_ratio(out, q, k, v) > 1.0


# the float32 kernel's terms (part of q or p, part of k or v), smallest
# first, as csrc/flash_attention.cu issues them
TERMS_X6 = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
TERMS_X3 = ((1, 0), (0, 1), (0, 0))
TERMS_X1 = ((0, 0),)
LOG2E = 1.4426950408889634


def _tc_add(acc, prods, tc):
    """One tensor-core k-step: 16 exact products summed into the float32
    accumulator with one rounding, to nearest ("rn") or truncated ("rz",
    the worse case)."""
    v = acc.double() + prods
    r = v.float()
    if tc == "rz":
        over = r.double().abs() > v.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _parts_product(a, b, terms, tc, acc=None):
    """sum over `terms` (smallest first) and k-steps of 16 of a_i @ b_j,
    a's and b's parts from `bf16x3_split_masked`, into a fresh tensor-core
    accumulator (or `acc`)."""
    pa = [t.double() for t in bf16x3_split_masked(a)]
    pb = [t.double() for t in bf16x3_split_masked(b)]
    depth = a.shape[-1]
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i, j in terms:
        for k0 in range(0, depth, 16):
            acc = _tc_add(acc, pa[i][..., k0:k0 + 16]
                          @ pb[j][..., k0:k0 + 16, :], tc)
    return acc


def _emulate_f32_kernel(q, k, v, terms=TERMS_X6, tc="rz", bk=32):
    """The float32 kernel's arithmetic on the CPU: key tiles of `bk`;
    S = Q K^T and P V as products of the truncated bf16 parts of q, k, v
    and p over `terms`, each k-step of 16 exact products added into a
    tensor-core accumulator with one rounding `tc`; the online softmax in
    log2 units in float32 (its exp2 correctly rounded, where the kernel's
    MUFU.EX2 is within 2 ulp).  S starts afresh each tile; P V accumulates
    into O through every tile, O rescaled by alpha (rounded to nearest)
    once the tile's P V has landed, in the kernel's order.  Errors against
    the plain version: at the test shapes bf16x6 stays within 0.04 of
    F32's bound; at 1x4096x4096x128, 5.4e-6, 0.18 of it (a fresh
    accumulator per tile promoted into O: 1.1e-6).  At 2x256x256x64 the
    three terms hh, hm, mh alone reach 1.1e-4, 1.34 times the bound, and
    one term (q, k, v and p each rounded to bf16) 2.4e-2."""
    H, Sq, hd = q.shape
    Sk = k.shape[1]
    scale_log2 = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    m = torch.full((H, Sq, 1), float("-inf"))
    l = torch.zeros(H, Sq, 1)
    o = torch.zeros(H, Sq, hd)
    pending = None               # the previous tile's p and v
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = _parts_product(q, kt.transpose(1, 2), terms, tc)
        keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
        s = s.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        alpha = torch.exp2((m - m_new).double()).float()
        p = torch.exp2(s.double() * scale_log2.double()
                       - m_new.double()).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        if pending is not None:
            o = _parts_product(*pending, terms, tc, acc=o) * alpha
        pending = (p, vt)
    o = _parts_product(*pending, terms, tc, acc=o)
    return o / l.clamp_min(1e-20)


# (H, Sq, Sk, hd, reference bq, bk): the test shapes and a ragged Sq > Sk
F32_EMU_CASES = [(H, S, S, hd, bq, bk) for H, S, hd, bq, bk in SHAPES] + [
    (2, 96, 40, 16, 32, 16)]


@pytest.mark.parametrize("tc", ["rz", "rn"])
@pytest.mark.parametrize("case", F32_EMU_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_f32_kernel_emulation_matches_reference(case, tc):
    """bf16x6 with the tensor cores' adds truncated or rounded to nearest:
    within F32 of the JAX op (Pallas in interpret mode) and of the plain
    version, at the reference's test shapes and a ragged Sq > Sk case."""
    H, Sq, Sk, hd, bq, bk = case
    q, k, v = _qkv(H, Sq, Sk, hd, Sq + hd)
    j_op, _ = _jax(q, k, v, bq, bk)
    T = torch.from_numpy
    got = _emulate_f32_kernel(T(q), T(k), T(v), tc=tc)
    np.testing.assert_allclose(got.numpy(), j_op, **F32)
    torch.testing.assert_close(got, flash_attention_ref(T(q), T(k), T(v)),
                               **F32)


@pytest.mark.parametrize("terms", [TERMS_X3, TERMS_X1], ids=["x3", "x1"])
def test_fewer_bf16_terms_break_f32(terms):
    """Three terms per product (hh, hm, mh) or one (every operand rounded
    to bf16, as a single bf16 pass computes) fall outside F32 of the plain
    version where six keep within it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 256, 256, 64, 5))
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(_emulate_f32_kernel(q, k, v), want, **F32)
    assert not torch.allclose(_emulate_f32_kernel(q, k, v, terms), want,
                              **F32)


@pytest.mark.parametrize("elem_bytes,want_ms", [(2, 0.5560), (4, 1.6680)],
                         ids=["bf16", "f32"])
def test_k4_bound_at_chameleon_shape(elem_bytes, want_ms):
    """`chip_smoke.k4_bound_ms` at H=64, S=4096, hd=128, both legs at the
    bf16 tensor-core rate, 989 TFLOP/s: bf16 prices QK^T as one and PV as
    three bf16 passes, (1 + 3) x 1.3746e11 flop; f32 prices six passes
    for each product (bf16x6), 12 x 1.3746e11 flop.  Both are bound by
    operations; the f32 work on the FFMA pipes would take 4.1037 ms."""
    smoke = chip_smoke()
    assert smoke.k4_pairs(4096, 4096) == 8_390_656
    ms, by = smoke.k4_bound_ms(64, 4096, 4096, 128, elem_bytes)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=1e-4)
    assert smoke.k4_ffma_ms(64, 4096, 4096, 128) == pytest.approx(
        4.1037, rel=1e-4)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version, f32 and bf16, at the
    reference's shapes and a ragged Sq > Sk case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [(H, S, S, hd) for H, S, hd, _, _ in SHAPES] + [(2, 96, 40, 16)]
    for H, Sq, Sk, hd in cases:
        q, k, v = (torch.from_numpy(a).to(dev)
                   for a in _qkv(H, Sq, Sk, hd, Sq))
        for bq in (32, 64):
            torch.testing.assert_close(flash_attention(q, k, v, bq=bq, bk=bq),
                                       flash_attention_ref(q, k, v), **F32)
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        torch.testing.assert_close(flash_attention(qb, kb, vb).float(),
                                   flash_attention_ref(qb, kb, vb).float(),
                                   **BF16)
