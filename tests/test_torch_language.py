"""Mirror of tests/test_language.py on the port: every test of that module
runs its own body with `mm` standing for the port (tests/_torch_shim.py),
each render on the port's CPU route and held against the reference's
`render(..., interpret=True)` at rtol=1e-4, atol=1e-5 (or the test's own
tighter tolerance) before the test's assertions see it.

The module's `_WhileSpy` counts `jax.lax.while_loop` entries, that is the
loops that did not unroll statically; here it counts the loops that the
port's evaluator ran on another route than the static unroll
(the counters `loop.masked` and `loop.kernel`: the masked loop, or
kernel B3's wrapper), so its eight tests hold the port's unroll decisions.

Left out, because they spy on or call the reference's jit and Pallas
machinery, which the port does not have (the port's own tests of its
counterpart are named):

- test_pallas_while_safe_calls_mosaic_probed: reads the Pallas engine's
  SAFE_CALLS (the port's: tests/test_torch_while.py).
- test_pallas_while_engine_excludes_atan2_body,
  test_pallas_while_on_overrides_static_unroll,
  test_pallas_while_on_forces_engine_regardless_of_sampler,
  test_wk_engine_rejects_unshadowed_angle_internal: count launches of the
  Pallas while engine by replacing `while_kernel.launch`
  (tests/test_torch_while.py holds B3's eligibility and routes).
- test_render_animation_chunked: patches the reference's api module to
  chunk its one-program sweep (the port's sweep is a loop of renders:
  tests/test_torch_animation.py).
- test_render_all_frames_frame_offset: calls the reference's private
  `Filter._renderer(...).render_all_frames` (the port's frame internal of
  a sweep: tests/test_torch_animation.py).
"""

import pytest

import test_language as reference
from _torch_shim import reference_cases, run_case
from mathmap_tpu_torch.utils.trace import since, snapshot

LEFT_OUT = {
    "test_pallas_while_safe_calls_mosaic_probed",
    "test_pallas_while_engine_excludes_atan2_body",
    "test_pallas_while_on_overrides_static_unroll",
    "test_pallas_while_on_forces_engine_regardless_of_sampler",
    "test_wk_engine_rejects_unshadowed_angle_internal",
    "test_render_animation_chunked",
    "test_render_all_frames_frame_offset",
}

CASES = reference_cases(reference, LEFT_OUT)


class LoopRouteSpy:
    """`_WhileSpy` on the port: `calls` counts the loops evaluated inside
    the block that did not take the static unroll (the `loop.kernel` and
    `loop.masked` counters)."""

    def __enter__(self):
        self._before = snapshot()
        return self

    def __exit__(self, *exc):
        return False

    @property
    def calls(self):
        counters = since(self._before)["counters"]
        return counters.get("loop.kernel", 0) + counters.get("loop.masked", 0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_language_on_the_port(case, monkeypatch, tmp_path):
    _, fn, kwargs = case
    monkeypatch.setattr(reference, "_WhileSpy", LoopRouteSpy)
    run_case(reference, fn, kwargs, monkeypatch, tmp_path=tmp_path)


def test_every_reference_test_is_mirrored_or_left_out():
    names = {n for n in vars(reference) if n.startswith("test_")}
    assert LEFT_OUT <= names
    assert {c[1].__name__ for c in CASES} == names - LEFT_OUT
