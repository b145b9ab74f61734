"""The port's ``ds_report`` (``deepspeed_tpu_torch.env_report``).

Its op table is the kernel libraries' entries (``ops/op_builder
.SIGNATURES``), one row each; a library is compatible only where ``nvcc``
and a compute-capability-9.0 card are both present, so without either
every row reads not compatible, and the kernel gate (the build) fails
with a message instead of a traceback.
"""

import pytest
import torch

from deepspeed_tpu_torch import env_report
from deepspeed_tpu_torch.ops import op_builder
from torch_threads import _one_torch_thread  # noqa: F401


def _no_nvcc():
    raise RuntimeError("nvcc not found")


@pytest.mark.parametrize("nvcc,card,want", [
    (False, None, False), (True, None, False), (False, (9, 0), False),
    (True, (8, 0), False), (True, (9, 0), True)])
def test_op_report_rows_are_the_signatures(nvcc, card, want, monkeypatch,
                                           capsys):
    monkeypatch.setattr(env_report, "nvcc_version",
                        lambda: "12.8" if nvcc else None)
    monkeypatch.setattr(env_report, "card_capability", lambda: card)
    rows = env_report.op_report()
    assert [r[0] for r in rows] == sorted(op_builder.SIGNATURES)
    assert all(r[1] == op_builder.SIGNATURES[r[0]][0] for r in rows)
    assert all(r[2] is want for r in rows)
    out = capsys.readouterr().out
    assert out.count(env_report.OKAY if want else env_report.NO) == \
        len(op_builder.SIGNATURES)


def test_without_nvcc_or_a_card_nothing_is_compatible(monkeypatch, capsys):
    """This host as it is, and with nvcc hidden: no row is compatible, the
    debug report names no device, and the kernel gate returns 1."""
    monkeypatch.setattr(op_builder, "_nvcc", _no_nvcc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ok, why = env_report.compatibility()
    assert not ok and "no nvcc" in why and "no CUDA device" in why
    assert not any(r[2] for r in env_report.op_report())
    rows = dict(env_report.debug_report())
    assert rows["device count"] == 0 and rows["nvcc version"] is None
    assert rows["torch version"] == torch.__version__
    assert env_report.main(kernel_gate=True) == 1
    assert "nvcc not found" in capsys.readouterr().out
