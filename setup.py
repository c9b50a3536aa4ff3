"""Build the native IO/runtime extension (C++, CPython C API).

    python setup.py build_ext --inplace

Also packages ``raytrace_tpu_torch``, the PyTorch/CUDA port, with its CUDA
sources (built with nvcc at first use, not here).
"""

import numpy as np
from setuptools import Extension, find_packages, setup

setup(
    name="raytrace_tpu",
    version="0.1.0",
    packages=find_packages(include=["raytrace_tpu*"]),
    package_data={"raytrace_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "raytrace_native",
            sources=["native/raytrace_native.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17"],
            language="c++",
        )
    ],
)
