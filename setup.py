"""Package build: python extension for host-native ops + console scripts.

Parity: reference ``setup.py`` (op pre-compile via ``DS_BUILD_OPS`` becomes
``DSTPU_BUILD_OPS`` — when set, the C++ host ops (cpu_adam, aio) are
compiled at install time instead of first use; Pallas ops need no AOT step,
XLA compiles them).
"""

import os

from setuptools import find_packages, setup

ext_modules = []
cmdclass = {}

if os.environ.get("DSTPU_BUILD_OPS", "0") == "1":
    from setuptools import Extension
    ext_modules = [
        Extension(
            "deepspeed_tpu.ops.native_ext",
            sources=["deepspeed_tpu/ops/csrc/cpu_adam.cpp",
                     "deepspeed_tpu/ops/csrc/aio.cpp"],
            extra_compile_args=["-O3", "-fopenmp", "-march=native",
                                "-std=c++17"],
            extra_link_args=["-fopenmp"],
        )
    ]

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native training/inference framework with DeepSpeed's "
                "capabilities (JAX/XLA/Pallas)",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch*"]),
    include_package_data=True,
    scripts=["bin/deepspeed", "bin/ds_report", "bin/ds_bench"],
    entry_points={
        "console_scripts": [
            "ds_report=deepspeed_tpu.env_report:cli_main",
        ],
    },
    install_requires=["jax", "numpy", "optax", "flax", "orbax-checkpoint"],
    python_requires=">=3.10",
    ext_modules=ext_modules,
)
