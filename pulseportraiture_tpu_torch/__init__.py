"""pulseportraiture_tpu_torch: wideband and narrowband TOAs in PyTorch and CUDA.

A port of `pulseportraiture_tpu` (JAX/XLA/Pallas) to PyTorch, with the
device kernels written by hand in CUDA C++ for Hopper (`csrc/`).  The JAX
package stays the reference: the port's CPU tests run both packages on the
same inputs.  Layers follow the JAX package:

  ops/       transforms, the fused setup (DFT + cross-spectrum) and the
             moments reductions, each kernel beside its plain twin
  fitters/   sufficient statistics, the batched trust-region Newton loop,
             the batched portrait fit, FFTFIT and the pat-style estimators
  models/    spline and Gaussian template evaluation (host numpy)
  io/        archive loading (the PSRFITS codec is shared with the JAX
             package, which imports no JAX at those modules)
  pipelines/ GetTOAs: archives -> batched fits -> TOAs
  parallel/  batch- and channel-sharded fits over several devices
  cli/       pptoas, ppzap, ppalign, ppspline, ppgauss
  viz, profiling  the plots (matplotlib, imported when one is drawn) and
             the trace hooks (torch.profiler)

Every entry point takes an explicit `device`; float32 is the working type
on the card, float64 the parity type on the CPU.  This package imports
`torch` and never `jax`.
"""

__version__ = "0.1.0"
