"""The share of the noise layer's Perlin evaluations that kernel B6 ran, in
%: the program's counter `noise.kernel_points` (the points of each `noise`
call that went through the kernel, which is every call on the card) over
its counter `noise.points` (the points of every call, the loop probes'
included), times 100, both over every call of the process, traced or not,
warm-up included. Nothing to read where the program keeps no
`noise.kernel_points`, as a program from before B6 does or one that
renders on the CPU, or no `noise.points`."""

from bench_torch.harness import program


def read(r: dict):
    got = program._snapshot()
    if got is None:
        return None
    counters = got[0]["counters"]
    kernel, points = counters.get("noise.kernel_points"), counters.get("noise.points")
    if not points or kernel is None:
        return None
    return 100.0 * kernel / points
