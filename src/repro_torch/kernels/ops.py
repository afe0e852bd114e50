"""Public entry points of the port's kernels: checks and dispatch.

A CPU tensor goes to the plain PyTorch version (`repro_torch.kernels.ref`;
`repro_torch.xla_order` for the elementwise math); a CUDA tensor goes to the
hand-written Hopper kernel (`csrc/irc_mvm.cu` for the IRC MVM,
`csrc/ternary_matmul.cu` for the ternary matmul, `csrc/flash_attention.cu`
for causal attention, `csrc/xla_math.cu` for the fused multiply-add,
erf_inv and exp in XLA's float32 rounding, `csrc/threefry.cu` for the
die sampling's threefry draws, `repro_torch.prng`'s plain versions on the
CPU), or the call raises — there is no fallback from the card to the
plain version.
Each kernel wrapper counts its launches in a plain integer (`LAUNCHES`), so a
run can show that its main path went through the kernel; calls served by the
plain version do not count.  The threefry kernel's draws are also counted by
tail (`TAIL_LAUNCHES`: "measured" is the measured device backend's mask).

Nothing needs padding: the kernels mask their ragged edges themselves.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch import xla_order as xo
from repro_torch.kernels.irc_mvm import check_tile
from repro_torch.kernels.ref import (IrcEpilogueParams,
                                     flash_attention_ref, irc_mvm_chips_ref,
                                     irc_mvm_ref, ternary_matmul_ref)

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES: Dict[str, int] = {"irc_mvm_chips": 0, "irc_mvm": 0,
                            "ternary_matmul": 0, "flash_attention": 0,
                            "xla_fma": 0, "xla_erf_inv": 0, "xla_exp": 0,
                            "threefry": 0}
#: threefry draw launches by tail since the last `reset_launches()`, each
#: also one of LAUNCHES["threefry"]
TAIL_LAUNCHES: Dict[str, int] = {t: 0 for t in prng.TAILS}


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for counts in (LAUNCHES, TAIL_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _check(x, ep, en, gp, gn, eps_sa, rnd_bits):
    if ep.ndim != 3 or en.shape != ep.shape:
        raise ValueError(f"ep/en must be [C,R,N], got {tuple(ep.shape)} and "
                         f"{tuple(en.shape)}")
    C, R, N = ep.shape
    if x.ndim not in (2, 3) or x.shape[-1] != R or (
            x.ndim == 3 and x.shape[0] != C):
        raise ValueError(f"x must be [B,{R}] or [{C},B,{R}], got "
                         f"{tuple(x.shape)}")
    B = x.shape[-2]
    if gp.shape != gn.shape or gp.shape not in ((R, N), (C, R, N)):
        raise ValueError(f"gp/gn must be [{R},{N}] or [{C},{R},{N}], got "
                         f"{tuple(gp.shape)} and {tuple(gn.shape)}")
    for name, t in (("eps_sa", eps_sa), ("rnd_bits", rnd_bits)):
        if t.shape != (C, B, N):
            raise ValueError(f"{name} must be [{C},{B},{N}], got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (x, ep, en, gp, gn, eps_sa, rnd_bits)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    return devs.pop()


def irc_mvm_chips(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
                  gp: torch.Tensor, gn: torch.Tensor, eps_sa: torch.Tensor,
                  rnd_bits: torch.Tensor, params: IrcEpilogueParams,
                  tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Chip-batched fused IRC MVM: x [B,R] shared (or [C,B,R] per chip),
    effective planes ep/en [C,R,N], placement planes gp/gn [R,N] shared or
    [C,R,N], periphery noise eps_sa/rnd_bits [C,B,N] -> [C,B,N] float32,
    in ONE kernel launch on the card, at row tile `tile` (one of
    `irc_mvm.TILES`; None: the default).  Any other tile raises ValueError,
    on the CPU too, where the plain version serves every tile."""
    tile = check_tile(tile)
    dev = _check(x, ep, en, gp, gn, eps_sa, rnd_bits)
    if dev.type == "cpu":
        return irc_mvm_chips_ref(x, ep, en, gp, gn, eps_sa, rnd_bits, params)
    out = _launch(dev, x, ep, en, gp, gn, eps_sa, rnd_bits, params, tile)
    LAUNCHES["irc_mvm_chips"] += 1
    return out


def irc_mvm(x: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
            gp: torch.Tensor, gn: torch.Tensor, eps_sa: torch.Tensor,
            rnd_bits: torch.Tensor, params: IrcEpilogueParams
            ) -> torch.Tensor:
    """Single-chip fused IRC MVM: x [B,R], planes [R,N], eps_sa/rnd_bits
    [B,N] -> [B,N]; the C = 1 case of the same kernel."""
    if x.ndim != 2 or ep.ndim != 2:
        raise ValueError(f"irc_mvm takes x [B,R] and planes [R,N], got "
                         f"{tuple(x.shape)} and {tuple(ep.shape)}")
    args = (x, ep[None], en[None], gp, gn, eps_sa[None], rnd_bits[None])
    dev = _check(*args)
    if dev.type == "cpu":
        return irc_mvm_ref(x, ep, en, gp, gn, eps_sa, rnd_bits, params)
    out = _launch(dev, *args, params)[0]
    LAUNCHES["irc_mvm"] += 1
    return out


def _launch(dev, x, ep, en, gp, gn, eps_sa, rnd_bits, params, tile=None):
    """One kernel launch on checked operands at row tile `tile`; raises if
    the kernel cannot be built or the launch is refused (there is no
    fallback)."""
    if dev.type != "cuda":
        raise RuntimeError(f"the IRC MVM runs on CPU or CUDA, not {dev}")
    from repro_torch.kernels import irc_mvm as kern
    kern.load()
    ops = [t.contiguous().float() for t in
           (x, ep, en, gp, gn, eps_sa, rnd_bits)]
    C, _, N = ep.shape
    out = torch.empty((C, x.shape[-2], N), dtype=torch.float32, device=dev)
    kern.launch_chips(*ops, out, params, tile)
    return out


def _check_ternary(x: torch.Tensor, w_t: torch.Tensor) -> torch.device:
    if x.ndim != 2 or w_t.ndim != 2 or x.shape[1] != w_t.shape[0]:
        raise ValueError(f"ternary_matmul takes x [B,K] and w_t [K,N], got "
                         f"{tuple(x.shape)} and {tuple(w_t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_t.dtype != torch.int8:
        raise ValueError(f"w_t must be int8 in {{-1,0,+1}}, got {w_t.dtype}")
    if x.device != w_t.device:
        raise ValueError(f"x and w_t must be on one device, got {x.device} "
                         f"and {w_t.device}")
    return x.device


def ternary_matmul(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """Dense ternary matmul: x [B,K] float32 or bfloat16, w_t [K,N] int8
    in {-1,0,+1} -> [B,N] float32, in ONE kernel launch on the card."""
    dev = _check_ternary(x, w_t)
    if dev.type == "cpu":
        return ternary_matmul_ref(x, w_t)
    if dev.type != "cuda":
        raise RuntimeError(f"ternary_matmul runs on CPU or CUDA, not {dev}")
    from repro_torch.kernels import ternary_matmul as kern
    kern.load()
    out = torch.empty((x.shape[0], w_t.shape[1]), dtype=torch.float32,
                      device=dev)
    kern.launch(x.contiguous(), w_t.contiguous(), out)
    LAUNCHES["ternary_matmul"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bq: int = 64, bk: int = 64
                    ) -> torch.Tensor:
    """Causal flash attention: q [H,Sq,hd], k/v [H,Sk,hd] (float32 or
    bfloat16, one dtype) -> [H,Sq,hd] in q's dtype, in one kernel call on
    the card (bfloat16: one launch; float32: two, a split of k and v into
    bfloat16 parts, then the attention), counted once.  Both kernels
    run on the tensor cores and compute in float32 as the plain version
    does.  `bq`/`bk` mirror the JAX wrapper's signature: they are checked
    (32 or 64) but pick nothing in either kernel, whose tiles are their own
    (128 query rows; 64 keys in bfloat16, 32 in float32).

    The kernel masks ragged Sq and Sk itself, so nothing is padded.  Like
    the JAX package's wrapper, it takes the causal case only."""
    if not causal:
        raise ValueError("flash_attention supports the causal case only")
    from repro_torch.kernels import flash_attention_cuda as kern
    kern.check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=True)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CPU or CUDA, not "
                           f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kern.launch(q, k, v, out, bq, bk)
    LAUNCHES["flash_attention"] += 1
    return out


def xla_fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as XLA contracts it: a, b and c are
    tensors (cast to float32) or Python floats and broadcast; in ONE kernel
    launch on the card, read through the operands' strides.

    Plain tensors with no dispatch mode active call `_fma` directly.  Any
    other tensor (a fake one under `FakeTensorMode`, a DTensor, one under a
    counting mode) goes through the custom op `repro_torch::xla_fma` (each
    operand a tensor or None beside its float), so a fake tensor gets its
    shape from the op's fake implementation and a DTensor its placements
    from the op's pointwise sharding rule, and neither reaches a kernel.
    The direct call spares the custom op's dispatch on the paths whose
    host queues the kernels."""
    tensors = [v for v in (a, b, c) if torch.is_tensor(v)]
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"xla_fma: operands on several devices {devs}")
    if not devs:
        return xo.fma_plain(a, b, c)
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"xla_fma runs on CPU or CUDA, not {dev}")
    if (torch._C._len_torch_dispatch_stack() == 0
            and all(type(t) is torch.Tensor for t in tensors)):
        return _fma(a, b, c)
    args = [v if torch.is_tensor(v) else None for v in (a, b, c)]
    floats = [0.0 if torch.is_tensor(v) else float(v) for v in (a, b, c)]
    return torch.ops.repro_torch.xla_fma(*args, *floats)


def _fma(a, b, c) -> torch.Tensor:
    """`xla_fma` on tensors of one device: the plain version on the CPU,
    the `xla_fma` kernel on the card."""
    tensors = [v for v in (a, b, c) if torch.is_tensor(v)]
    dev = tensors[0].device
    if dev.type == "cpu":
        return xo.fma_plain(a, b, c)
    from repro_torch.kernels import xla_math as kern
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    if len(shape) > kern.MAX_DIMS:
        raise ValueError(f"xla_fma takes at most {kern.MAX_DIMS} axes, got "
                         f"{tuple(shape)}")
    ops_ = [v.float() if torch.is_tensor(v) else v for v in (a, b, c)]
    if 0 in shape:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    out = kern.launch_fma(*ops_, shape, dev)
    LAUNCHES["xla_fma"] += 1
    return out


@torch.library.custom_op("repro_torch::xla_fma", mutates_args=())
def _xla_fma_op(a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                c: Optional[torch.Tensor], sa: float, sb: float,
                sc: float) -> torch.Tensor:
    """`xla_fma` with each operand a tensor or None beside its float."""
    return _fma(*(t if t is not None else f
                  for t, f in ((a, sa), (b, sb), (c, sc))))


@_xla_fma_op.register_fake
def _xla_fma_fake(a, b, c, sa, sb, sc):
    tensors = [t for t in (a, b, c) if t is not None]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    return tensors[0].new_empty(shape, dtype=torch.float32)


def _register_fma_sharding() -> None:
    """The DTensor rule of `repro_torch::xla_fma`: pointwise.  The output
    is replicated, or sharded on one dim with every operand that spans
    that dim sharded alike (a broadcast operand replicated)."""
    try:
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import register_sharding
    except ImportError:                     # a build without distributed
        return

    @register_sharding(torch.ops.repro_torch.xla_fma.default)
    def _fma_strategy(a, b, c, sa, sb, sc):
        specs = (a, b, c)
        shapes = [tuple(s.tensor_meta.shape) if s is not None else None
                  for s in specs]
        out = torch.broadcast_shapes(*(sh for sh in shapes if sh is not None))
        rules = [([Replicate()], [Replicate() if s is not None else None
                                  for s in specs] + [None] * 3)]
        for d in range(len(out)):
            ins = []
            for sh in shapes:
                if sh is None:
                    ins.append(None)
                    continue
                k = d - (len(out) - len(sh))
                ins.append(Shard(k) if k >= 0 and sh[k] == out[d] and
                           out[d] > 1 else Replicate())
            if out[d] > 1:
                rules.append(([Shard(d)], ins + [None] * 3))
        return rules


_register_fma_sharding()


def _unary_device(name: str, x: torch.Tensor) -> torch.device:
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        raise ValueError(f"{name} takes a float32 tensor, got "
                         f"{getattr(x, 'dtype', type(x))}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} runs on CPU or CUDA, not {x.device}")
    return x.device


def xla_erf_inv(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """scale * erf_inv(x) in XLA's float32 rounding (what
    `jax.random.normal` computes from its uniforms), for a float32 tensor;
    in ONE kernel launch on the card."""
    if _unary_device("xla_erf_inv", x).type == "cpu":
        return xo.erf_inv_plain(x, scale)
    if x.numel() == 0:
        return torch.empty_like(x)
    from repro_torch.kernels import xla_math as kern
    out = kern.launch_erf_inv(x.contiguous(), scale)
    LAUNCHES["xla_erf_inv"] += 1
    return out


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) in XLA CPU's float32 rounding, for a float32 tensor; in ONE
    kernel launch on the card."""
    if _unary_device("xla_exp", x).type == "cpu":
        return xo.exp_plain(x)
    if x.numel() == 0:
        return torch.empty_like(x)
    from repro_torch.kernels import xla_math as kern
    out = kern.launch_exp(x.contiguous())
    LAUNCHES["xla_exp"] += 1
    return out


def _key_device(name: str, key: torch.Tensor) -> torch.device:
    if not (torch.is_tensor(key) and key.dtype == torch.int64
            and key.ndim >= 1 and key.shape[-1] == 2):
        raise ValueError(f"{name}: a key is an int64 tensor [..., 2], got "
                         f"{getattr(key, 'dtype', type(key))} "
                         f"{tuple(getattr(key, 'shape', ()))}")
    if key.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} runs on CPU or CUDA, not {key.device}")
    return key.device


def _key_rows(key: torch.Tensor, lead) -> torch.Tensor:
    """Keys broadcast to `lead` as [L, 2] rows with adjacent words (a view
    where one exists: an expanded single key has row stride 0)."""
    rows = key.expand(tuple(lead) + (2,)).reshape(-1, 2)
    return rows if rows.stride(1) == 1 else rows.contiguous()


def threefry_fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`prng.fold_in`: key [..., 2] and data (an int or an integer tensor)
    broadcast; ONE launch of the threefry kernel on the card."""
    dev = _key_device("fold_in", key)
    if dev.type == "cpu":
        return prng.fold_in_plain(key, data)
    from repro_torch.kernels import threefry as kern
    lead, d, scalar = key.shape[:-1], None, 0
    if torch.is_tensor(data):
        d = data.to(device=key.device, dtype=torch.int64)
        lead = torch.broadcast_shapes(lead, d.shape)
        d = d.expand(lead).reshape(-1).contiguous()
    else:
        scalar = int(data) & prng.MASK32
    if math.prod(lead) == 0:
        return torch.empty(tuple(lead) + (2,), dtype=torch.int64,
                           device=key.device)
    out = kern.launch_pairs(_key_rows(key, lead), d, scalar, 1)
    LAUNCHES["threefry"] += 1
    return out.reshape(tuple(lead) + (2,))


def threefry_split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`prng.split` under the scheme in force: [..., 2] -> [..., num, 2];
    ONE launch of the threefry kernel on the card."""
    dev = _key_device("split", key)
    if dev.type == "cpu":
        return prng.split_plain(key, num)
    from repro_torch.kernels import threefry as kern
    num, lead = int(num), key.shape[:-1]
    partitionable = prng.is_partitionable()
    prng.check_words(num if partitionable else 2 * num)
    if num == 0 or math.prod(lead) == 0:
        return torch.empty(tuple(lead) + (num, 2), dtype=torch.int64,
                           device=key.device)
    rows = _key_rows(key, lead)
    out = (kern.launch_pairs(rows, None, 0, num) if partitionable
           else kern.launch_draw(rows, 2 * num, True, "bits"))
    LAUNCHES["threefry"] += 1
    return out.reshape(tuple(lead) + (num, 2))


def threefry_draw(key: torch.Tensor, shape: Sequence[int], tail: str, *,
                  minval: float = 0.0, maxval: float = 1.0,
                  scale: float = 1.0, p: float = 0.5,
                  table=None) -> torch.Tensor:
    """`prng.random_bits` (tail "bits"), `uniform`, `normal`, `lognormal`
    (scale = sigma), `bernoulli` or `measured` (table = (xp, fp)) under the
    scheme in force: key batch axes lead `shape`; ONE launch of the
    threefry kernel on the card."""
    dev = _key_device(tail, key)
    shape = tuple(int(s) for s in shape)
    lo, span = prng.tail_consts(tail, minval, maxval)
    if tail == "measured":
        table = prng.check_table(table)
        scale = prng.HALF_SQRT2
    if dev.type == "cpu":
        return prng.tail_plain(prng.random_bits_plain(key, shape), tail,
                               minval=minval, maxval=maxval, scale=scale,
                               p=p, table=table)
    from repro_torch.kernels import threefry as kern
    n, lead = math.prod(shape), key.shape[:-1]
    prng.check_words(n)
    if n == 0 or math.prod(lead) == 0:
        return torch.empty(tuple(lead) + shape, dtype=kern.TAILS[tail][1],
                           device=key.device)
    out = kern.launch_draw(_key_rows(key, lead), n,
                           not prng.is_partitionable(), tail, lo, span,
                           prng.normal_factor(scale), p, table=table)
    LAUNCHES["threefry"] += 1
    TAIL_LAUNCHES[tail] += 1
    return out.reshape(tuple(lead) + shape)


def irc_mvm_from_mapped(key: torch.Tensor, x_bits: torch.Tensor, mapped,
                        cfg, spec, *, sa_extra_units: float = 0.0,
                        output: str = "binary") -> torch.Tensor:
    """Kernel-backed single-chip `crossbar_forward` (single-shot): samples
    the chip's planes and periphery noise with the same key discipline,
    then calls `irc_mvm`.  Runs where `x_bits` lives."""
    from repro_torch.core.crossbar import sample_chip_planes
    from repro_torch.core.mapping import extend_inputs
    gp, gn = mapped.g_pos, mapped.g_neg
    ep, en, k_sa = sample_chip_planes(key, gp, gn, mapped.scheme, cfg, spec)
    k_off, k_rng = prng.split(k_sa)
    x_ext = extend_inputs(x_bits, mapped)
    B, N = x_ext.shape[0], gp.shape[1]
    eps_sa = prng.normal(k_off, (B, N))
    rnd = prng.bernoulli(k_rng, 0.5, (B, N))
    params = IrcEpilogueParams.from_macro(
        spec, sa_extra=sa_extra_units, output=output,
        apply_nonlinearity=cfg.nonlinearity, apply_ir=cfg.ir_drop,
        apply_sa=cfg.sa_variation, apply_range=cfg.sensing_range)
    return irc_mvm(x_ext, ep, en, gp, gn, eps_sa, rnd, params)
