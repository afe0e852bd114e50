"""`xla_fma`'s launch geometry (`kernels/xla_math.py::fma_geometry`): the
axes it coalesces and the kernel path it picks, on CPU tensors (the
geometry reads only shapes, strides and pointers).  The kernel itself is
held against `xla_order.fma_plain` on the card
(`tests/test_torch_sum_order.py`, `chip_smoke.py` phase 3)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.xla_math import FMA_PATHS, fma_geometry  # noqa: E402


def _geometry(*args):
    shape = torch.broadcast_shapes(*(v.shape for v in args
                                     if torch.is_tensor(v)))
    return fma_geometry(shape, [v.expand(shape) if torch.is_tensor(v)
                                else v for v in args])


def test_epilogue_broadcast_coalesces_to_two_axes_on_the_float4_path():
    """The SA epilogue: sigma [B, N] shared by the chips of [C, B, N]."""
    sigma, eps, diff = (torch.ones(64, 60), torch.ones(4, 64, 60),
                        torch.ones(4, 64, 60))
    sizes, strides, path = _geometry(sigma, eps, diff)
    assert sizes == [4, 64 * 60]
    assert strides == [[0, 1], [64 * 60, 1], [64 * 60, 1]]
    assert path == "vec4"


def test_contiguous_and_scalar_operands_are_one_axis():
    c = torch.ones(6, 5, 4)
    assert _geometry(-1.5, c, 1.0) == ([120], [[0], [1], [0]], "vec4")
    assert _geometry(torch.tensor(2.0), c, c)[0] == [120]


@pytest.mark.parametrize("args, path", [
    ((torch.ones(7), torch.ones(7), 1.0), "32"),              # odd axis
    ((torch.ones(5, 8)[:, ::2], torch.ones(4), 0.5), "32"),    # strided
    ((torch.ones(1001)[1:], torch.ones(1000), 1.0), "32"),     # misaligned
    ((torch.ones(640, 3)[:, :1], torch.ones(640, 16), 0.0), "vec4"),
    ((torch.ones(2, 3, 4, 5, 6), torch.ones(6), torch.ones(2, 1, 4, 1, 6)),
     "64"),                                                   # 5 axes left
])
def test_path_choice(args, path):
    assert _geometry(*args)[2] == path
    assert path in FMA_PATHS


def test_zero_dim_and_size_one_axes():
    sizes, strides, path = _geometry(torch.tensor(1.0), torch.tensor(2.0),
                                     torch.tensor(3.0))
    assert (sizes, path) == ([1], "32")
    sizes, _, _ = _geometry(torch.ones(1, 9, 1), torch.ones(9, 1), 2.0)
    assert sizes == [9]


def test_large_offsets_take_the_64_bit_path():
    """A view whose reach passes 2**31 elements (a meta tensor: strides
    without storage, so nothing large is allocated)."""
    huge = torch.empty_strided((2, 2), (2**31, 0), device="meta")
    sizes, strides, path = fma_geometry((2, 2), [huge, 1.0, 0.0])
    assert path == "64" and strides[0] == [2**31, 0]
