"""Plain PyTorch references of the configurations' filters, written from
MathMap's semantics and imported from nothing of the program.

Every function takes (params, t, width, height, image, dtype, device) and
returns the (height, width, 4) RGBA frame clipped to [0, 1] in `dtype`:
float32 for the comparison, bfloat16 for its control. `image` is the
(H, W, 4) uint8 input on `device`, or None.
"""
