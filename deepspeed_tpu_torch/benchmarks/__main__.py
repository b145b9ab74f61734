"""``ds_bench`` for the port: ``python -m deepspeed_tpu_torch.benchmarks
<suite> [flags]``.

Counterpart of ``bin/ds_bench``'s ``SUITES``: the first argument names the
suite, and ``comm`` (the communication suite) is the default, as in
DeepSpeed's ``ds_bench``.  ``train``, ``inference`` and ``serving`` run on
the card (``--device cpu`` / ``--cpu`` off it); ``aio``, ``cpu_adam`` and
``offload`` time the host side of ZeRO-Offload; the suites the port has
not ported raise ``NotImplementedError`` naming their ROADMAP item.
"""

import importlib
import sys

# suite -> its module, or the ROADMAP item that ports it
SUITES = {
    "comm": "A8",
    "train": "deepspeed_tpu_torch.benchmarks.training",
    "inference": "deepspeed_tpu_torch.benchmarks.inference",
    "serving": "deepspeed_tpu_torch.benchmarks.serving",
    "aio": "deepspeed_tpu_torch.benchmarks.aio",
    "cpu_adam": "deepspeed_tpu_torch.benchmarks.cpu_adam",
    "offload": "deepspeed_tpu_torch.benchmarks.offload",
}
DEFAULT_SUITE = "comm"


def main(argv=None):
    """Run the suite named by ``argv[0]`` (default ``comm``) on the rest
    of ``argv``; returns what the suite's ``main`` returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    suite = argv.pop(0) if argv and argv[0] in SUITES else DEFAULT_SUITE
    target = SUITES[suite]
    if "." not in target:
        raise NotImplementedError(
            f"ds_bench {suite}: the {suite} suite is not ported yet "
            f"(ROADMAP {target})")
    return importlib.import_module(target).main(argv)


if __name__ == "__main__":
    main()
