"""The bfloat16 ``--log-every`` lines of the port against the JAX CLI's.

The JAX package reduces a field in its own dtype: ``jnp.mean`` and
``jnp.sum`` accumulate in float32 and round the result to bfloat16, and
``velocity_l2`` squares the bfloat16 difference before the sum.  The port's
log lines do the same (``utils/diagnostics.py``), so every value a bfloat16
line prints is a bfloat16 value.  Every reduction a line logs (``mean``,
``velocity_l2`` and the float32 ``residual``) is held here to JAX's within
one bfloat16 ulp of JAX's value.  ``min`` and ``max`` are not reductions
but the values of single cells, and the two packages' bfloat16 fields
differ within the reference's bfloat16 tolerance, ``32 eps max(|v|, 1)``
(tests/test_torch_bf16.py: the frameworks round a step's taps in another
order), so they are held to that: wave3d's ``max`` at step 8 lies two ulps
from JAX's, one cell's rounding, not the reduction's.

A float32 line keeps its float32 reductions: the last test pins its values
to the float32 formulas.

The one negative bfloat16 subnormal that advect3d's lines print
(``min=-9.18355e-41`` against JAX's ``min=0``) comes from the per-op
rounding order of the step, within the tolerance of
tests/test_torch_bf16.py::test_plain_bf16_step_matches_jax; no case here
prints one.
"""

import logging
import math

import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu import cli as jcli

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import diagnostics as tdiag

BF16 = "bfloat16"

CASES = {
    "heat3d": ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8",
               "--dtype", BF16, "--log-every", "4"],
    "wave3d": ["--stencil", "wave3d", "--grid", "16,16,32", "--iters", "8",
               "--dtype", BF16, "--log-every", "4"],
    # BASELINE config 5's rehearsal line (tests/test_cli.py:422-424)
    "config5": ["--stencil", "wave3d", "--grid", "192,64,128", "--iters",
                "8", "--mesh", "8,1,1", "--fuse", "4", "--fuse-kind",
                "stream", "--dtype", BF16, "--mem-check", "error",
                "--log-every", "4"],
}


def _step_lines(caplog, name):
    """{step: {key: the logged text of its value}} of one logger."""
    out = {}
    for r in caplog.records:
        msg = r.getMessage()
        if r.name == name and msg.startswith("step "):
            parts = msg.split()
            out[int(parts[1])] = dict(kv.split("=") for kv in parts[2:])
    return out


def _bf16_ulp(v: float) -> float:
    """One bfloat16 ulp at ``v`` (8 significant bits)."""
    if v == 0.0:
        return 2.0 ** -133
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


def _as_bf16(text: str) -> float:
    """The bfloat16 value nearest a logged ``%.6g`` text."""
    return torch.tensor(float(text), dtype=torch.float64).to(
        torch.bfloat16).item()


# The reference's bfloat16 field tolerance, 32 eps max(|v|, 1), eps = 2**-7.
def _cell_tolerance(v: float) -> float:
    return 32 * 2.0 ** -7 * max(abs(v), 1.0)


def _is_bf16_text(text: str) -> bool:
    """Whether a ``%.6g`` text names a bfloat16 value: rounding it to
    bfloat16 and printing it again gives the same text."""
    return f"{_as_bf16(text):.6g}" == text


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_log_lines_match_jax(case, caplog, monkeypatch):
    """heat3d and wave3d (16, 16, 32) and config 5's rehearsal line, bf16,
    --log-every 4, through both CLIs: the same steps and keys, every
    port value but the residual a bfloat16 value, every reduction within
    one bfloat16 ulp of JAX's, min and max within the cell tolerance."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    args = CASES[case]
    with caplog.at_level(logging.INFO):
        assert jcli.main(args) == 0
        jlines = _step_lines(caplog, "mpi_cuda_process_tpu")
        caplog.clear()
        assert tcli.main(args + ["--device", "cpu"]) == 0
        tlines = _step_lines(caplog, "mpi_cuda_process_tpu_torch")
    assert sorted(tlines) == sorted(jlines) == [4, 8]
    for step, jd in jlines.items():
        td = tlines[step]
        assert sorted(td) == sorted(jd)
        for key, jtext in jd.items():
            if key == "residual":  # float32 in both: the text's 6 digits
                jv, tv = float(jtext), float(td[key])
                tol = _bf16_ulp(jv) + 1e-5 * abs(jv)
            else:
                assert _is_bf16_text(td[key]), (case, step, key, td[key])
                jv, tv = _as_bf16(jtext), _as_bf16(td[key])
                tol = (_cell_tolerance(jv) if key in ("min", "max")
                       else _bf16_ulp(jv))
            assert abs(tv - jv) <= tol, (case, step, key, tv, jv)


def test_f32_lines_keep_their_float32_reductions():
    """Float32 fields reduce as before the repair: the mean of the float32
    field, and velocity_l2 the float32 norm of the difference, whole and
    over the blocks of a sharded field."""
    rng = np.random.default_rng(7)
    st = port.make_stencil("wave3d")
    u, p = (torch.from_numpy(rng.random((8, 12, 16), dtype=np.float32))
            for _ in range(2))
    want_l2 = torch.sqrt(torch.sum((u - p) ** 2)).item()
    d = tdiag.field_diagnostics(st, (u, p))
    assert d["mean"] == torch.mean(u).item()
    assert d["velocity_l2"] == want_l2
    mesh = tmesh.make_mesh((2,), [torch.device("cpu")] * 2)
    su, sp = tstepper.shard_fields((u, p), mesh, 3)
    ds = tdiag.field_diagnostics(st, (su, sp))
    halves = [torch.sum((a - b) ** 2) for a, b in zip(su, sp)]
    assert ds["velocity_l2"] == torch.sqrt(halves[0] + halves[1]).item()
    assert ds["mean"] == ((torch.sum(su[0]) + torch.sum(su[1]))
                          / u.numel()).item()
    assert all(isinstance(v, float) for v in ds.values())
