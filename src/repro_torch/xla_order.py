"""The float32 orders of the JAX package's reductions, in plain torch.

The reference leaves its sums, scans and the rounding of `a * b + c` to
XLA.  Torch's own `sum` and `cumsum` add in other orders, and torch's CPU
kernels round a product before adding it, so the same float32 inputs give
other last bits; a last bit moves an SA decision at a near-tie, and a
flipped decision moves every layer after it.  The helpers here add in
XLA's order, read on jax 0.9.0 with XLA's CPU backend (the one the
reference's CPU tests and this port's parity tests run):

  * a reduction over a non-minor axis (`jnp.sum(blocks, axis=1)` over IR
    blocks or partial-sum chunks, the count sums) is sequential, left to
    right (`seq_sum`);
  * inside one jit, a product feeding an add is contracted into one fused
    multiply-add with a single rounding: `1 - alpha * cum`, the Horner
    steps of the nonlinearity ratio, the SA offset's sigma and
    `diff + sigma * eps`, and a weighted sum `sum(blocks * factors)`
    (`fma`, `seq_fma_sum`);
  * `jnp.cumsum` lowers to a `reduce_window` that XLA's CPU backend
    evaluates as a two-level scan: a sequential prefix inside each run of
    16 elements, then the earlier runs' total added to each element
    (`scan16_iter`); the IR-drop suffix sums are that scan over the
    reversed blocks;
  * `log1p` and `exp` are XLA's own float32 polynomials (Cephes' forms),
    with the same contractions (`log1p`, `exp`), and `sqrt` is correctly
    rounded (`sqrt`; torch's CPU float32 sqrt is not, in about one case in
    200, and its exp differs in the last bit on about one value in ten).
    `jax.random.normal` is XLA's `erf_inv` polynomial (`erf_inv`), which
    reaches log1p and sqrt; the device-variation mask is an exp;
  * the measured device backend's mask `jnp.interp(norm.cdf(z), xp, fp)`
    reaches XLA's float32 `erf` (a rational form, `erf`), its `erfc`
    (Cephes' erfcf around one exp, `erfc`), `ndtr` (both branches
    evaluated and selected, `ndtr`) and `jnp.interp` (a search in JAX's
    float order, then `fp[i-1] + (x - xp[i-1]) / dx * df` with the product
    and sum fused, `interp`); XLA flushes subnormal results to zero.

`tests/test_torch_sum_order.py` holds every helper against its `jnp`
counterpart bit for bit at the detector's shapes (16, 17 and 18 IR blocks
of 60 columns) or across the float32 range, so a jax release that changes
an order names the op.

The sums and scans are plain torch on any device.  `fma`, `erf_inv` and
`exp` dispatch through `repro_torch.kernels.ops`: a CPU tensor goes to the
plain version here (`fma_plain`, `erf_inv_plain`, `exp_plain`, which
emulate each fused multiply-add in float64), a CUDA tensor to one launch
of a hand-written kernel (`csrc/xla_math.cu`) that gives the same bits in
one pass.  The plain versions use `fma_plain` throughout, so the card can
hold the kernels against them.  The IRC MVM kernel (`csrc/irc_mvm.cu`)
computes the same orders with explicit `__fmaf_rn`/`__fadd_rn`/`__fmul_rn`.
"""
from __future__ import annotations

import struct
from typing import Iterator, Sequence

import torch

#: run length of XLA CPU's two-level `reduce_window` scan
SCAN_BLOCK = 16
#: elements per float64 slice of `fma`
FMA_SLICE = 1 << 22


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(err != 0, torch.nextafter(s, toward), s).float()


def _ops():
    from repro_torch.kernels import ops
    return ops


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (a fused multiply-add); a, b, c are
    tensors or Python floats (taken as float32) and broadcast.  One launch
    of the `xla_fma` kernel on CUDA tensors, `fma_plain` on CPU ones."""
    return _ops().xla_fma(a, b, c)


def erf_inv(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """scale * XLA's float32 `erf_inv` (see `erf_inv_plain`).  One launch of
    the `xla_erf_inv` kernel on a CUDA tensor."""
    return _ops().xla_erf_inv(x, scale)


def exp(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp` on float32 as XLA's CPU backend computes it (see
    `exp_plain`).  One launch of the `xla_exp` kernel on a CUDA tensor."""
    return _ops().xla_exp(x)


def fma_plain(a, b, c) -> torch.Tensor:
    """Plain version of `fma`, on any device.

    The product of two float32 values is exact in float64; the float64 sum
    is made round-to-odd (nudged one float64 ulp towards the exact value
    whenever it is inexact), so the final rounding to float32 is the
    correctly rounded fused result, with no double rounding.  Large
    operands go through in slices of `FMA_SLICE` elements along their
    longest axis, so the float64 temporaries stay small."""
    dev = next((v.device for v in (a, b, c) if torch.is_tensor(v)), None)
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=dev)
               for v in (a, b, c))
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    n = 1
    for size in shape:
        n *= size
    if n <= FMA_SLICE:
        return _fma64(a, b, c)
    a, b, c = (v.expand(shape) for v in (a, b, c))
    dim = max(range(len(shape)), key=lambda d: shape[d])
    step = max(1, FMA_SLICE * shape[dim] // n)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    for lo in range(0, shape[dim], step):
        w = min(step, shape[dim] - lo)
        out.narrow(dim, lo, w).copy_(_fma64(
            a.narrow(dim, lo, w), b.narrow(dim, lo, w), c.narrow(dim, lo, w)))
    return out


def seq_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim`, one add at a time from index 0 upwards."""
    t = torch.movedim(t, dim, 0)
    acc = t[0]
    for k in range(1, t.shape[0]):
        acc = acc + t[k]
    return acc


def seq_fma_sum(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_k a_k * b_k over `dim` (a and b broadcast), sequential from index
    0, each step one fused multiply-add into the running sum."""
    a, b = torch.broadcast_tensors(a, b)
    a = torch.movedim(a, dim, 0)
    b = torch.movedim(b, dim, 0)
    acc = a[0] * b[0]
    for k in range(1, a.shape[0]):
        acc = fma(a[k], b[k], acc)
    return acc


def scan16_iter(items: Sequence[torch.Tensor]) -> Iterator[torch.Tensor]:
    """The inclusive prefix sums of `items` in XLA CPU's `reduce_window`
    order, one at a time: sequential inside each run of `SCAN_BLOCK`, then
    the total of the earlier runs (itself summed run by run) added to each
    element."""
    carry = None
    for s in range(0, len(items), SCAN_BLOCK):
        acc = None
        for k in range(s, min(len(items), s + SCAN_BLOCK)):
            acc = items[k] if acc is None else acc + items[k]
            out = acc if carry is None else acc + carry
            yield out
        carry = out


def _f32(llvm_hex: str) -> float:
    """A float32 constant as LLVM prints it (the double of the same value,
    in hex)."""
    return struct.unpack(">d", bytes.fromhex(llvm_hex[2:]))[0]


# XLA CPU's float32 log: log(m * 2^e) for m in [sqrt(1/2), sqrt(2)) as a
# degree-9 polynomial in z = m - 1 (Cephes' logf), evaluated as three
# interleaved Horner chains; ln 2 split into a high and a low part
_LOG_P = tuple(map(_f32, (
    "0x3FB2043760000000", "0xBFBD7A3700000000", "0xBFBFCBA9E0000000",
    "0x3FC23D37E0000000", "0x3FC999D580000000", "0xBFCFFFFF80000000",
    "0x3FBDE4A340000000", "0xBFC555CA00000000", "0x3FD5555540000000")))
_SQRT_HALF = _f32("0x3FE6A09E60000000")
_LN2_LO = _f32("0xBF2BD01060000000")
_LN2_HI = _f32("0x3FE6300000000000")
_FLT_MIN = _f32("0x3810000000000000")
# XLA CPU's float32 log1p below |x| = sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x)
_LOG1P_SMALL = _f32("0x3FDA8279A0000000")
_LOG1P_Q = (1.0,) + tuple(map(_f32, (
    "0x402E2035A0000000", "0x4054C30B60000000", "0x406BB865A0000000",
    "0x4073519460000000", "0x406B0DB140000000", "0x404E0F3040000000")))
_LOG1P_P = tuple(map(_f32, (
    "0x3F07BC0960000000", "0x3FDFE818A0000000", "0x401A509F40000000",
    "0x403DE97380000000", "0x404E798EC0000000", "0x404C8E75A0000000",
    "0x40340A2020000000")))


def _log(y: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 natural log, op for op."""
    full = lambda v: torch.full_like(y, v)
    ym = torch.where(y > _FLT_MIN, y, full(_FLT_MIN))
    bits = ym.view(torch.int32)
    e = ((bits >> 23) - 127).float()
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRT_HALF
    e = (e + 1.0) - low.float()
    z = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z2 = z * z
    z3 = z2 * z
    f = fma_plain
    a = f(f(z, _LOG_P[0], _LOG_P[1]), z, _LOG_P[6])
    b = f(f(z, _LOG_P[2], _LOG_P[3]), z, _LOG_P[7])
    c = f(f(z, _LOG_P[4], _LOG_P[5]), z, _LOG_P[8])
    t = f(f(f(a, z3, b), z3, c), z3, e * _LN2_LO)
    r = f(e, _LN2_HI, f(-z2, 0.5, z) + t)
    r = torch.where(y <= 0, full(float("nan")), r)
    r = torch.where(y == 0, full(float("-inf")), r)
    return torch.where(y == float("inf"), y, r)


def log(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log` on float32 as XLA's CPU backend computes it (normal and
    zero inputs; subnormal ones are read as the smallest normal); plain
    torch on any device."""
    return _log(x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """`jnp.log1p` on float32 as XLA's CPU backend computes it (subnormal
    inputs flushed to zero, as there); plain torch on any device."""
    x = torch.where(x.abs() < _FLT_MIN, x * 0.0, x)
    zero = x * 0.0
    q = zero + _LOG1P_Q[0]
    for coef in _LOG1P_Q[1:]:
        q = fma_plain(q, x, coef)
    p = zero + _LOG1P_P[0]
    for coef in _LOG1P_P[1:]:
        p = fma_plain(p, x, coef)
    x2 = x * x
    small = x + fma_plain(x2, -0.5, (x * x2) * (p / q))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(x + 1.0))


# XLA CPU's float32 exp (Cephes' expf): x = n ln2 + r with n = floor(x log2e
# + 1/2), ln 2 split into a high and a low part, e^r a degree-7 polynomial
_EXP_LO = _f32("0xC055F33340000000")
_EXP_HI = _f32("0x4056333340000000")
_LOG2E = _f32("0x3FF7154760000000")
_EXP_P = tuple(map(_f32, (
    "0x3F2A0D2CE0000000", "0x3F56E879C0000000", "0x3F81112100000000",
    "0x3FA5553820000000", "0x3FC5555540000000"))) + (0.5,)


def exp_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `exp` (subnormal results flushed to zero, as XLA's
    CPU backend does), on any device."""
    f = fma_plain
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(f(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = f(-_LN2_LO, n, f(-_LN2_HI, n, x))
    y = torch.full_like(x, _EXP_P[0])
    for coef in _EXP_P[1:]:
        y = f(y, r, coef)
    y = 1.0 + f(y, r * r, r)
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    y = y * scale
    return torch.where(y < _FLT_MIN, torch.zeros_like(y), y)  # flush to 0


# XLA's float32 erf_inv (Giles' single-precision polynomial), below and
# above w = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_plain(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain version of `erf_inv`, on any device: XLA's float32 `erf_inv`
    polynomial (the one `jax.random.normal` lowers to), with XLA CPU's own
    `log1p`, a correctly rounded `sqrt` and each Horner step one fused
    multiply-add, as XLA evaluates them; times `scale` (one rounding)."""
    w = -log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt(w) - 3.0)
    coef = lambda lo_c, hi_c: torch.where(
        small, torch.tensor(lo_c, device=x.device),
        torch.tensor(hi_c, device=x.device))
    p = coef(_ERFINV_LT5[0], _ERFINV_GT5[0])
    for lo_c, hi_c in zip(_ERFINV_LT5[1:], _ERFINV_GT5[1:]):
        p = fma_plain(p, w, coef(lo_c, hi_c))
    return scale * torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, which
    rounds twice without error for a float32 result)."""
    return torch.sqrt(x.double()).float()


def div(a: torch.Tensor, b) -> torch.Tensor:
    """Correctly rounded float32 a / b (through float64: the float64
    quotient of two float32 values rounds to the float32 one without
    error)."""
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return (a.double() / b.double()).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """c0 x^(k-1) + ... + c(k-1), each step one fused multiply-add."""
    p = fma_plain(x, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        p = fma_plain(p, x, c)
    return p


# XLA CPU's float32 erf: x clamped to +-3.74392128, then x P(x^2) / Q(x^2),
# both polynomials fused multiply-adds
_ERF_CLAMP = 3.74392128
_ERF_P = (2.29050653e-4, 0.00340829091, 0.0509556942, 0.185208321,
          1.12837911)
_ERF_Q = (-1.17916031e-7, 2.35479656e-5, 0.00101796258, 0.0140704699,
          0.110985048, 0.497469246, 1.0)
# XLA's float32 erfc (Cephes' erfcf): 1 - x P(x^2) below |x| = 1, else
# exp(-x^2) / |x| times R(1/x^2) below |x| = 2 or S(1/x^2) from it on,
# 0 where -x^2 < -88.7228394, reflected to 2 - erfc(-x) for negative x
_ERFC_P = (7.85386146e-5, -8.0101937e-4, 0.00518832775, -0.0268538129,
           0.112835854, -0.37612626, 1.12837911)
_ERFC_R = (0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000468,
           -0.494451523, 0.340488, -0.274112701, 0.563825965)
_ERFC_S = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
           0.42184633, -0.282076746, 0.564189494)
_ERFC_MINLOG = -88.7228394
#: float32(sqrt(1/2)), the constant of `jax.scipy.special.ndtr`
HALF_SQRT2 = 0.70710677


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values flushed to (signed) zero, as XLA's CPU
    backend flushes the results of its float32 arithmetic."""
    return torch.where(torch.abs(x) < _FLT_MIN, x * 0.0, x)


def erf(x: torch.Tensor) -> torch.Tensor:
    """`lax.erf` on float32 as XLA's CPU backend computes it; plain torch
    on any device."""
    c = _ftz(torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP))
    c2 = c * c
    return _ftz(div(c * _horner(c2, _ERF_P), _horner(c2, _ERF_Q)))


def _erfc_small(x: torch.Tensor) -> torch.Tensor:
    """erfc below |x| = 1: 1 - x P(x^2), the last step fused."""
    return fma_plain(-x, _horner(x * x, _ERFC_P), 1.0)


def _erfc_large(x: torch.Tensor) -> torch.Tensor:
    """erfc from |x| = 1 on: exp(-x^2) / |x| times R or S in 1/x^2."""
    x2 = x * x
    a = torch.abs(x)
    q = div(torch.ones_like(x2), x2)
    poly = torch.where(a < 2.0, _horner(q, _ERFC_R), _horner(q, _ERFC_S))
    big = _ftz(_ftz(exp_plain(-x2) * div(torch.ones_like(a), a)) * poly)
    big = torch.where(-x2 < _ERFC_MINLOG, torch.zeros_like(big), big)
    return torch.where(x < 0.0, 2.0 - big, big)


def _where_split(cond: torch.Tensor, x: torch.Tensor, f_true, f_false
                 ) -> torch.Tensor:
    """where(cond, f_true(x), f_false(x)) for elementwise f_true and
    f_false, each evaluated only where its result is kept."""
    out = torch.empty_like(x)
    out[cond] = f_true(x[cond])
    out[~cond] = f_false(x[~cond])
    return out


def erfc(x: torch.Tensor) -> torch.Tensor:
    """`lax.erfc` on float32 as XLA's CPU backend computes it (which
    evaluates both branches and selects); plain torch on any device."""
    return _where_split(torch.abs(x) < 1.0, x, _erfc_small, _erfc_large)


def ndtr_from_w(w: torch.Tensor) -> torch.Tensor:
    """`jax.scipy.special.ndtr` from its w = x sqrt(1/2) on:
    0.5 * (1 + erf(w) below |w| = sqrt(1/2), else 2 - erfc(|w|) for
    positive w and erfc(|w|) otherwise), as XLA evaluates it."""
    def upper(v):
        e = erfc(torch.abs(v))
        return torch.where(v > 0.0, 2.0 - e, e)
    y = _where_split(torch.abs(w) < HALF_SQRT2, w, lambda v: 1.0 + erf(v),
                     upper)
    return y * 0.5


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """`jax.scipy.stats.norm.cdf` on float32 as XLA's CPU backend
    computes it; plain torch on any device."""
    return ndtr_from_w(x * HALF_SQRT2)


#: `jnp.interp` treats an interval at most this wide as empty
INTERP_EPS = 2.0 ** -46  # the spacing of float32's eps


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in JAX's sort order: -0 as +0, one NaN
    above +inf, then the total order of the bits."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    k = x.view(torch.int32)
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)` on float32 as XLA's CPU backend computes it:
    i = searchsorted(xp, x, side='right') clipped to [1, len(xp) - 1],
    fp[i-1] + (x - xp[i-1]) / (xp[i] - xp[i-1]) * (fp[i] - fp[i-1]) with
    the product and sum one fused multiply-add (fp[i-1] where the interval
    is at most `INTERP_EPS` wide), fp[0] below xp[0] and fp[-1] above
    xp[-1]; plain torch on any device."""
    n = xp.shape[0]
    i = torch.searchsorted(_order_key(xp).contiguous(),
                           _order_key(x).contiguous(), right=True)
    i = torch.clamp(i, 1, n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    empty = torch.abs(dx) <= INTERP_EPS
    f = fma_plain(div(x - x0, torch.where(empty, torch.ones_like(dx), dx)),
                  f1 - f0, f0)
    f = torch.where(empty, f0, f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
