"""Each kernel's name in the trace, and the bytes or operations its work
needs, counted from shapes and by the benchmark's own files."""
