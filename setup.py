"""Packaging for shadowing-tpu (TPU-native Path Shadowing Monte Carlo).

Builds the optional native shard-loader extension when a C toolchain is
available; the package works without it (pure-numpy fallback).
"""
import os

from setuptools import Extension, find_packages, setup

ext_modules = []
if os.environ.get("SHADOWING_TPU_NO_NATIVE") != "1":
    ext_modules.append(
        Extension(
            "shadowing_tpu.native._npyloader",
            sources=["shadowing_tpu/native/npyloader.c"],
            extra_compile_args=["-O3", "-std=c11", "-pthread"],
            extra_link_args=["-pthread"],
            optional=True,
        )
    )

setup(
    name="shadowing-tpu",
    version="0.1.0",
    description="TPU-native Path Shadowing Monte Carlo (JAX/XLA/Pallas)",
    packages=find_packages(include=["shadowing_tpu", "shadowing_tpu.*",
                                    "shadowing_tpu_torch",
                                    "shadowing_tpu_torch.*"]),
    package_data={"shadowing_tpu.data": ["_bundled/*.npz"],
                  "shadowing_tpu_torch": ["csrc/*.cu"],
                  "shadowing_tpu_torch.native": ["npyloader.c"],
                  "shadowing_tpu_torch.data": ["_bundled/*.npz"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pandas"],
    extras_require={"viz": ["matplotlib"], "test": ["pytest", "scipy"],
                    "torch": ["torch"]},
    ext_modules=ext_modules,
)
