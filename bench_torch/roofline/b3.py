"""Kernel B3, the generated per-pixel while loop (`while_loop_kernel`).

Its operations are the loop's pixel iterations, counted by the plain
reference, times the operations of one iteration as the `.mm` source
writes them (the configuration file gives that count); the least time is
those operations over the float32 rate."""

KERNEL = "while_loop_kernel"


def operations(pixel_iterations: int, ops_per_iteration: int) -> int:
    return int(pixel_iterations) * int(ops_per_iteration)
