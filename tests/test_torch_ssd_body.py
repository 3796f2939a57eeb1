"""Which K4 body the model's kernel path runs, and the rule that let the
bf16 training forward take the tensor-core body (ROADMAP Queue 3 item 1),
on the CPU (no card: the choice reads dtypes, shapes and addresses only).

- ``ssd_body`` picks the tensor-core body for bfloat16 at P 64, N 128, a
  chunk in ``TC_CHUNKS`` and x/Bm/Cm on 16-byte boundaries, and the
  CUDA-core body for anything else;
- ``chip_smoke.witness_verdict`` passes a body when, on every seed, both
  of its gaps to the f64 witness (worst leaf, normwise) are within 2 x
  the plain bf16 path's.
"""

import pathlib
import sys

import pytest
import torch

from repro_torch.kernels.ssd_scan import TC_CHUNKS, ssd_body

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the witness rule lives beside its phase)


def _inputs(dtype=torch.bfloat16, P=64, N=128, offset=None):
    """x (1, 8, 2, P), Bm and Cm (1, 8, N); ``offset`` names the operand
    taken as a view one element into its storage (2 bytes in bf16)."""
    def make(shape, name):
        if name != offset:
            return torch.zeros(shape, dtype=dtype)
        flat = torch.zeros(1 + torch.Size(shape).numel(), dtype=dtype)
        return flat[1:].view(shape)

    return make((1, 8, 2, P), "x"), make((1, 8, N), "Bm"), make((1, 8, N), "Cm")


@pytest.mark.parametrize("chunk", TC_CHUNKS)
def test_bf16_at_mamba2_heads_takes_the_tensor_cores(chunk):
    x, Bm, Cm = _inputs()
    assert x.data_ptr() % 16 == 0
    assert ssd_body(x, Bm, Cm, chunk) == "tensor_cores"


@pytest.mark.parametrize(
    "case,kw,chunk",
    [
        ("float32", dict(dtype=torch.float32), 256),
        ("float64", dict(dtype=torch.float64), 256),
        ("P 32", dict(P=32), 256),
        ("N 64", dict(N=64), 256),
        ("chunk 32", {}, 32),
        ("chunk 512", {}, 512),
        ("x misaligned", dict(offset="x"), 256),
        ("Bm misaligned", dict(offset="Bm"), 256),
        ("Cm misaligned", dict(offset="Cm"), 256),
    ],
)
def test_everything_else_takes_the_cuda_cores(case, kw, chunk):
    x, Bm, Cm = _inputs(**kw)
    assert ssd_body(x, Bm, Cm, chunk) == "cuda_cores", case


def _reading(plain, **bodies):
    """One seed's readings: (worst leaf, normwise) per path."""
    return {"gaps": {p: dict(leaf=leaf, normwise=norm)
                     for p, (leaf, norm) in dict(plain=plain, **bodies).items()}}


def test_witness_rule_on_the_measured_readings():
    """The H100 readings of the witness phase (seeds 0 and 1): both bodies
    pass."""
    readings = [
        _reading((0.4097, 0.1165), cuda_cores=(0.3971, 0.1138), tensor_cores=(0.3850, 0.1047)),
        _reading((0.2405, 0.1128), cuda_cores=(0.2355, 0.1230), tensor_cores=(0.2648, 0.1018)),
    ]
    assert chip_smoke.witness_verdict(readings) == {"cuda_cores": True, "tensor_cores": True}


@pytest.mark.parametrize(
    "seed1_body,passes",
    [
        ((0.48, 0.22), True),  # both readings at 2 x e_plain: within
        ((0.49, 0.10), False),  # the worst leaf beyond 2 x e_plain
        ((0.30, 0.23), False),  # normwise beyond 2 x e_plain
    ],
)
def test_witness_rule_needs_both_readings_on_every_seed(seed1_body, passes):
    readings = [
        _reading((0.4, 0.1), body=(0.5, 0.1)),
        _reading((0.24, 0.11), body=seed1_body),
    ]
    assert chip_smoke.witness_verdict(readings) == {"body": passes}
    assert chip_smoke.witness_verdict(readings, factor=1.0) == {"body": False}
