"""Expression database: a categorized library of filter sources (the port
of `mathmap_tpu/expression_db.py`).

Reference: `expression_db.c` — scans an expressions directory tree of `.mm`
(MathMap source) and `.mmc` (composer s-expr) files into a categorized DB;
filters can reference each other by name, enabling user-defined function
composition (SURVEY.md §2.1 filter-database row, §3.5 [unverified — mount
empty, SURVEY.md §0]).

The directory structure gives the category tree (Colors/, Distorts/, ...).
`ExpressionDB.compile(name)` compiles a filter with the WHOLE library as its
filter environment, so any library filter can call any other by name — the
trace inlines the callee (source-level composition, §3.4)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .api import Filter
from .lang import astnodes as A
from .lang.parser import parse
from .utils.errors import MMError, MMNameError


@dataclass
class DBEntry:
    name: str
    category: str
    path: str
    source: str
    fdef: A.FilterDef
    program: A.Program
    doc: str = ""


def _leading_comment(source: str) -> str:
    lines = []
    for line in source.splitlines():
        line = line.strip()
        if line.startswith("#"):
            lines.append(line.lstrip("# "))
        elif line:
            break
    return " ".join(lines)


@dataclass
class ExpressionDB:
    root: str
    entries: dict = field(default_factory=dict)  # name -> DBEntry
    categories: dict = field(default_factory=dict)  # category -> [names]
    errors: list = field(default_factory=list)  # (path, error) skipped files

    def _add_source(self, path: str, category: str, source: str,
                    only_main: bool = False) -> None:
        try:
            program = parse(source)
        except MMError as exc:
            self.errors.append((path, str(exc)))
            return
        doc = _leading_comment(source)
        fdefs = program.filters[-1:] if only_main else program.filters
        for fdef in fdefs:
            if fdef.name in self.entries:
                continue
            self.entries[fdef.name] = DBEntry(
                name=fdef.name, category=category, path=path,
                source=source, fdef=fdef, program=program, doc=doc,
            )
            self.categories.setdefault(category, []).append(fdef.name)

    @classmethod
    def scan(cls, root: str, base: "ExpressionDB | None" = None) -> "ExpressionDB":
        """Scan a directory tree. `base` supplies EXTRA entries visible to
        composer (.mmc) name resolution — user-dir scans pass the bundled
        library here so a user composition can reference bundled filters
        (it used to resolve against the user dir alone and silently drop
        such compositions into db.errors)."""
        db = cls(root=root)
        mmc_files = []
        # pass 1: .mm sources populate the name->filter environment
        for dirpath, _dirnames, filenames in sorted(os.walk(root)):
            category = os.path.relpath(dirpath, root)
            if category == ".":
                category = ""
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                if fn.endswith(".mmc"):
                    mmc_files.append((path, category))
                elif fn.endswith(".mm"):
                    with open(path) as f:
                        db._add_source(path, category, f.read())
        # pass 2: composer graphs compile against the scanned library
        # (nodes reference .mm filters by name — SURVEY §3.4). A RETRY
        # loop makes .mmc -> .mmc references order-independent (a
        # composition referencing a later-scanned one used to fail by
        # lexicographic accident); only the final pass records errors.

        class _View:  # entries = db's + base's (db shadows base)
            @property
            def entries(self):
                merged = dict(base.entries) if base is not None else {}
                merged.update(db.entries)
                return merged

        view = _View()
        pending = list(mmc_files)
        while pending:
            failed = []
            for path, category in pending:
                try:
                    from .designer.graph import load_mmc

                    graph = load_mmc(path, db=view)
                    name = os.path.splitext(os.path.basename(path))[0]
                    source = graph.to_source(name=name)
                except Exception as exc:
                    failed.append((path, category, exc))
                    continue
                db._add_source(path, category, source, only_main=True)
            if len(failed) == len(pending):  # no progress: record and stop
                db.errors.extend((p, str(e)) for p, _c, e in failed)
                break
            pending = [(p, c) for p, c, _e in failed]
        return db

    def names(self):
        return sorted(self.entries)

    def library_defs(self) -> dict:
        """name -> FilterDef across the whole library."""
        return {name: e.fdef for name, e in self.entries.items()}

    def compile(self, name: str) -> Filter:
        """Compile `name` with every library filter in scope (filters-as-
        functions across files)."""
        if name not in self.entries:
            raise MMNameError(f"no filter named {name!r} in {self.root}")
        entry = self.entries[name]
        filt = Filter(entry.program, entry.fdef, entry.source)
        lib = self.library_defs()
        # file-local definitions shadow library ones
        merged = dict(lib)
        merged.update(filt.filters)
        filt.filters = merged
        return filt

    def tree(self) -> str:
        """Human-readable category tree (the GUI browse tree analog)."""
        out = []
        for cat in sorted(self.categories):
            out.append(f"{cat or '(root)'}/")
            for name in sorted(self.categories[cat]):
                doc = self.entries[name].doc
                out.append(f"  {name}" + (f" — {doc}" if doc else ""))
        return "\n".join(out)


def default_db() -> ExpressionDB:
    """The bundled filter library (repo filters/) merged with the user's
    library (~/.mathmap_tpu/expressions and $MMTPU_FILTER_PATH dirs) — the
    reference likewise scans both its installed and per-user expression
    trees [unverified]."""
    root = os.path.join(os.path.dirname(__file__), "..", "filters")
    db = ExpressionDB.scan(os.path.abspath(root))
    extra = [os.path.expanduser("~/.mathmap_tpu/expressions")]
    extra += [p for p in os.environ.get("MMTPU_FILTER_PATH", "").split(os.pathsep) if p]
    for path in extra:
        if os.path.isdir(path):
            # bundled entries stay visible to user .mmc name resolution
            user = ExpressionDB.scan(path, base=db)
            for name, entry in user.entries.items():
                if name in db.entries:  # shadowed: drop the old tree row
                    old_cat = db.entries[name].category
                    if name in db.categories.get(old_cat, []):
                        db.categories[old_cat].remove(name)
                cat = "User/" + entry.category if entry.category else "User"
                from dataclasses import replace as _dc_replace

                # entry.category must match the tree row it appears under
                db.entries[name] = _dc_replace(entry, category=cat)
                if name not in db.categories.setdefault(cat, []):
                    db.categories[cat].append(name)
            db.errors.extend(user.errors)
    return db
