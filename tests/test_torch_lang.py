"""The port's copy of the front end parses every library filter into an AST
structurally equal to the reference parser's."""

import dataclasses
import glob
import os

import pytest

from mathmap_tpu.lang.parser import parse as ref_parse
from mathmap_tpu_torch.lang.parser import parse as port_parse

FILTER_DIR = os.path.join(os.path.dirname(__file__), "..", "filters")
FILES = sorted(glob.glob(os.path.join(FILTER_DIR, "**", "*.mm"), recursive=True))


def dump(node):
    """Field-by-field dump, by class name, so the two packages' node
    classes compare equal when their structure is."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                tuple((f.name, dump(getattr(node, f.name)))
                      for f in dataclasses.fields(node)))
    if isinstance(node, (list, tuple)):
        return tuple(dump(x) for x in node)
    if isinstance(node, dict):
        return tuple(sorted((k, dump(v)) for k, v in node.items()))
    return node


def test_library_is_present():
    assert len(FILES) >= 150


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, FILTER_DIR))
def test_parser_matches_reference(path):
    with open(path) as fh:
        src = fh.read()
    assert dump(port_parse(src)) == dump(ref_parse(src))
