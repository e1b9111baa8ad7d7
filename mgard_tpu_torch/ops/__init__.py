"""Transform, quantizer and codec, with the CUDA kernels K1-K4 behind
their wrappers (``extract_kernels``, ``bp_kernels``)."""
