"""The evaluator's builtins on torch tensors. The table itself is
`registry.BUILTINS`, filled by `builtins.py` when `registry` is imported;
`libm` and `rand` import nothing else of the package, so the exported
artifacts' loader (generators/artifact.py) can register their ops alone.
"""
