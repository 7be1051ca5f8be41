"""rtvqa_tpu_torch — the PyTorch + CUDA port of ``rtvqa_tpu``.

Same layer map and module names as the JAX package, written in plain
PyTorch with hand-written CUDA kernels (``csrc/``) for the hot ops:

* ``cli``       — ``rtvqa-torch <config.json> <video>`` entry point.
* ``pipeline``  — orchestrator (encode → analyze → CSV row).
* ``metrics``   — the eight-metric complexity suite.
* ``ops``       — plain-PyTorch compute primitives (color, resize, scan, DCT,
                  histogram, edges, ORB count, block-matching motion).
* ``kernels``   — CUDA kernel wrappers beside their plain versions, and the
                  ``nvcc`` build/loader.
* ``device``    — device selection and the f32 precision settings.

Host IO, config, CSV sink and logging are reused from ``rtvqa_tpu`` by
import; none of those modules imports jax. This package never imports jax.
"""

__version__ = "0.1.0"
