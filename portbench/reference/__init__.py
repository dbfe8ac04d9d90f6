"""The plain reference the benchmark holds the program against.

Plain PyTorch and NumPy, written from the published description and from
frozen copies of plain code: it imports neither JAX, nor the JAX package,
nor anything of the program (``visiondepth3d_tpu_torch``), and takes
nothing the program made. Every product (einsum, linear, convolution,
attention) goes through ``precision.Mat``, which computes it in float32,
or in TF32 for the control.
"""
