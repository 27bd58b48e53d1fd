"""Tuple tag registry — the MathMap tuple/tag type system.

Every MathMap value is a tagged tuple `tag:[e1..en]` of length >= 1
(reference `tuples.c`/`tags.c` [unverified — mount empty, SURVEY.md §0]).
Known tags per SURVEY.md §2.1. Tags exist only at trace time in this rebuild
(they never reach the device program); lengths listed here are the canonical
lengths used by overload resolution — `None` means any length.
"""

from __future__ import annotations

NIL = "nil"

#: tag -> canonical length (None = variable)
KNOWN_TAGS: dict[str, int | None] = {
    "nil": None,
    "xy": 2,
    "ra": 2,
    "rgba": 4,
    "hsva": 4,
    "ri": 2,  # complex
    "m2x2": 4,
    "m3x3": 9,
    "v2": 2,
    "v3": 3,
    "quat": 4,
    "cquat": 4,
    "hyper": 4,  # hypercomplex
    "image": 1,
    "curve": 1,
    "gradient": 1,
}


def is_tag(name: str) -> bool:
    return name in KNOWN_TAGS


def tag_length(tag: str) -> int | None:
    return KNOWN_TAGS.get(tag)


def register_tag(name: str, length: int | None = None) -> None:
    """Intern a new tag (the reference's tag registry allows user tags).
    Re-registering with a CONFLICTING length raises — setdefault silently
    kept the stale length (review r3)."""
    existing = KNOWN_TAGS.get(name)
    if existing is not None and length is not None and existing != length:
        raise ValueError(
            f"tag {name!r} already registered with length {existing}, "
            f"cannot re-register as length {length}")
    KNOWN_TAGS.setdefault(name, length)
