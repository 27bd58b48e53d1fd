"""The port's copy of the static displacement bound (parallel/bounds.py)
against the reference's, for every filter of every `.mm` file in filters/,
at 64x48 and at 3840x2160: both None, or equal (dy, dx) tuples. The bound
must not depend on what the port has ported: builtins it lacks count as
builtins (ops/registry.is_builtin)."""

import os

import pytest

import mathmap_tpu as mm
import mathmap_tpu_torch as mt
from mathmap_tpu.parallel.bounds import infer_displacement_bound as ref_bound
from mathmap_tpu_torch.ops import registry as port_registry
from mathmap_tpu_torch.parallel.bounds import infer_displacement_bound

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _entries():
    """(relative path, filter name) of every filter definition under filters/."""
    from mathmap_tpu_torch.lang.parser import parse

    out = []
    root = os.path.join(ROOT, "filters")
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if fn.endswith(".mm"):
                path = os.path.join(dirpath, fn)
                with open(path) as fh:
                    for fdef in parse(fh.read()).filters:
                        out.append((os.path.relpath(path, ROOT), fdef.name))
    return out


ENTRIES = _entries()


@pytest.mark.parametrize("size", [(64, 48), (3840, 2160)], ids=["64x48", "3840x2160"])
@pytest.mark.parametrize("path,name", ENTRIES, ids=[f"{p}::{n}" for p, n in ENTRIES])
def test_displacement_bound_matches_the_reference(path, name, size):
    w, h = size
    full = os.path.join(ROOT, path)
    ref = mm.compile_file(full, main=name)
    port = mt.compile_file(full, main=name)
    want = ref_bound(ref.filters, ref.fdef, w, h, None)
    got = infer_displacement_bound(port.filters, port.fdef, w, h, None)
    assert got == want


def test_every_library_file_is_covered():
    assert len({p for p, _ in ENTRIES}) >= 150 and len(ENTRIES) >= 155


def test_is_builtin_counts_the_unported_builtins():
    assert port_registry.is_builtin("sin") and port_registry.is_builtin("rand")
    assert port_registry.is_builtin("gaussianBlur")
    assert not port_registry.is_builtin("no_such_builtin")
