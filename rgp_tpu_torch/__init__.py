"""rgp_tpu_torch: the PyTorch/CUDA port of :mod:`rgp_tpu`.

Each module mirrors the layout and names of its counterpart in ``rgp_tpu``
(``rgp_tpu/linalg.py`` -> ``rgp_tpu_torch/linalg.py`` and so on); the JAX
package is the reference each module is tested against in f64 on the CPU.

Entry points that create tensors (``models.rgp.init_params``,
``data.datasets.standardized_tensors``, ``convert.params_from_jax``) run on the
card unless the caller passes ``device="cpu"``; every other function follows
the device of its input tensors. The RBF Psi2 time sum on uncertain inputs runs
in a hand-written CUDA kernel (``ops/cuda/psi2.py``, ``csrc/psi2_fwd.cu``) for
float32 CUDA tensors.
"""

__version__ = "0.1.0"
