"""autosmoothquant_tpu_torch — the PyTorch / NVIDIA Hopper port of
``autosmoothquant_tpu``.

It serves the quantized checkpoints that
``autosmoothquant_tpu.convert.pipeline.save_quantized`` writes (W8A8 int8,
fp8 e4m3 dynamic or static, fp8 e5m2, W4A8 int4) of Llama-family and OPT
models on one H100.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package that the
serving path runs has a hand-written CUDA counterpart under ``csrc/``, built
with ``nvcc`` for ``sm_90a`` on first use (``kernels/_build.py``).

Layout mirrors the JAX package so each counterpart is easy to find:
  - ``quant/``    QuantConfig and the int8 / fp8 / int4 quantization math
  - ``kernels/``  int8, fp8 and int4 GEMMs, fused add+RMSNorm+quant and
                  add+LayerNorm+quant, flash attention: each a CUDA kernel
                  beside its plain PyTorch version
  - ``convert/``  safetensors reader, artifact loader, JAX-params carry-over
  - ``models/``   shared layers, the Llama, Gemma, Baichuan and OPT
                  families, the registry
  - ``serve/``    sampling, the static-batch generation engine and the
                  continuous-batching engine

Dispatch has no flag: a tensor on the CPU goes to the plain version, a CUDA
tensor to the kernel. Entry points default to ``device="cuda"`` and raise
where there is no card. This package never imports JAX or the JAX package.
"""

__version__ = "0.1.0"
