"""Export a filter: as an artifact that runs without the compiler
(artifact.py), as a runnable script or as its exported program's text
(standalone.py)."""
