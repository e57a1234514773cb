"""OronTTS on PyTorch and CUDA: the port of ``oron_tts_tpu`` to one NVIDIA H100.

The module layout mirrors the JAX package so each counterpart is easy to
find. Importing this package imports nothing heavy: kernels are compiled
(``ops/_build.py``) the first time a wrapper meets a CUDA tensor.
"""
