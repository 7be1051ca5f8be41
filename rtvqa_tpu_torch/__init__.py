"""rtvqa_tpu_torch — the PyTorch + CUDA port of ``rtvqa_tpu``.

Same layer map and module names as the JAX package, written in plain
PyTorch with hand-written CUDA kernels (``csrc/``) for the hot ops:

* ``cli``       — ``rtvqa-torch <config.json> <video>`` entry point.
* ``pipeline``  — orchestrator (encode → analyze → CSV row) and CSV sink.
* ``metrics``   — the eight-metric complexity suite, PSNR/SSIM, and the
                  full-reference quality chunk engine.
* ``vmaf``      — VMAF features (separable filters, motion, VIF, ADM) and
                  the model loader / SVR predictor.
* ``ops``       — plain-PyTorch compute primitives (color, resize, scan, DCT,
                  histogram, edges, ORB count, block-matching motion).
* ``kernels``   — CUDA kernel wrappers beside their plain versions, and the
                  ``nvcc`` build/loader.
* ``io``        — native libav decode/encode/probe (built from
                  ``native/rtvqa_io.cpp``) and streaming batches.
* ``config``, ``obs`` — config schema, logging, stage timer.
* ``device``    — device selection (``cuda`` unless the CPU is asked for)
                  and the f32 precision settings.

The package keeps its own copy of every host module it needs. It imports
nothing of ``rtvqa_tpu`` and never imports jax.
"""

__version__ = "0.1.0"
