"""gdmix-tpu on PyTorch and CUDA: the port of the JAX package `gdmix_tpu`.

The random-effect coordinate (per-entity logistic regressions, bucketed by
sample count and solved by batched damped Newton) runs here, with its Newton
and linear-solve kernels written by hand in CUDA C++ for Hopper (`csrc/`).
The JAX package beside it is the reference the tests compare against; this
package never imports it, nor JAX.
"""

__version__ = "0.1.0"
