"""Hand-written Hopper kernels of the port, one subpackage each:

    kernels/<name>/kernel.cu   CUDA C++ for sm_90a, plain C launcher
    kernels/<name>/ops.py      wrapper: checks, launch, launch count
    kernels/<name>/ref.py      the plain PyTorch version

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version.  ``runtime`` builds and loads the
kernels at first use.
"""
