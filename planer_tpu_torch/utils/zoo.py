"""Model zoo: the local cache, markdown manifests, download — the port's
copy of ``planer_tpu/utils/zoo.py``, whose downloads do not resolve names
through its online catalog.

``~/.planer_zoo`` cache, markdown-table file manifests (``get_source``),
``download``/``downloads`` with a progress callback, and ``Model()``/
``load()`` that decorate an imported ``planer_zoo.*`` package with
source/list_source/download and auto-load.  A manifest row's URL must carry
a scheme (``http://``, ``file://``, anything ``urllib`` opens); a bare name
is not resolved through a catalog: put the file into the cache dir instead.
``planer_catlog()`` still reads the catalog at ``CATALOG_URL``, on request.

Unlike the JAX package's module, importing this one creates no directory:
the cache dir is made when a download first writes into it.
"""
from __future__ import annotations

import importlib
import inspect
import json
import os
import pathlib
import re
import sys
import urllib.request

__all__ = ["root", "Model", "load", "download", "downloads", "source",
           "list_source", "get_source", "planer_catlog"]

root = str(pathlib.Path.home()) + "/.planer_zoo"

CATALOG_URL = "http://planer.imagepy.org/catlog.txt"


def progress(done: int, total: int, width: int = 30):
    """Default download progress: a single-line text bar on stderr."""
    frac = min(done / total, 1.0) if total else 1.0
    fill = int(width * frac)
    bar = "#" * fill + "." * (width - fill)
    end = "\n" if frac >= 1.0 else ""
    sys.stderr.write(f"\r  [{bar}] {frac:6.1%}{end}")
    sys.stderr.flush()


def download(url: str, path: str, info=print, progress=progress,
             chunk: int = 1 << 18):
    """Stream ``url`` to ``path`` with progress callbacks (percent of 100)."""
    info(f"download from {url}")
    req = urllib.request.Request(url, headers={"User-Agent": "Mozilla/5.0"})
    tmp = path + ".part"
    with urllib.request.urlopen(req) as resp, open(tmp, "wb") as out:
        total = int(resp.headers.get("Content-Length") or 0)
        got = 0
        while True:
            buf = resp.read(chunk)
            if not buf:
                break
            out.write(buf)
            got += len(buf)
            if total:
                progress(int(100 * got / total), 100)
    progress(100, 100)
    os.replace(tmp, path)


def planer_catlog() -> dict:
    """The catalog at ``CATALOG_URL`` (a JSON object of short names and
    download URLs).  Only this call reads it: ``downloads`` never does."""
    req = urllib.request.Request(CATALOG_URL,
                                 headers={"User-Agent": "Mozilla/5.0"})
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def source(mroot: str, lst: list) -> list:
    """Annotate a manifest with installed-state: rows become
    [name, required, installed, url]."""
    for row in lst:
        installed = os.path.exists(os.path.join(mroot, row[0]))
        if len(row) == 3:
            row.insert(2, installed)
        else:
            row[2] = installed
    return lst


def list_source(mroot: str, lst: list):
    rows = source(mroot, lst)
    name_w = max([len(r[0]) for r in rows] + [9]) + 2
    header = f"{'file':<{name_w}}{'required':<10}{'installed':<10}"
    print(header)
    print("=" * len(header))
    for name, req, inst, _url in rows:
        print(f"{name:<{name_w}}{('yes' if req else '-'):<10}"
              f"{('yes' if inst else '-'):<10}")


# manifest rows look like: | [name](url) | x | ... |
_MANIFEST_ROW = re.compile(r"^\s*\|\s*\[([^\]]+)\]\(([^)]*)\)\s*\|([^|]*)\|")


def get_source(path: str) -> list:
    """Parse the |File|Required|…| markdown table of a zoo package readme."""
    files = []
    in_table = False
    with open(path) as f:
        for line in f:
            if not in_table:
                in_table = "|file|" in line.replace(" ", "").lower()
                continue
            if "|" not in line:
                break
            m = _MANIFEST_ROW.match(line)
            if m:
                name, url, req = m.groups()
                files.append([name, req.strip() != "", url])
    return files


def downloads(mroot, lst, names="required", force=False, info=print,
              progress=progress):
    """Fetch manifest entries into ``mroot``.  ``names``: "required", "all",
    one name, or a list of names; already-installed files are skipped unless
    ``force``.  A URL with a scheme (``http://``, ``file://``, ...) is
    fetched as it is; a bare name raises ``FileNotFoundError`` naming the
    path in ``mroot`` where the file is expected (the JAX package resolves
    it through its online catalog)."""
    rows = source(mroot, lst)
    if names == "all":
        want = rows
    elif names == "required":
        want = [r for r in rows if r[1]]
    else:
        wanted = {names} if isinstance(names, str) else set(names)
        want = [r for r in rows if r[0] in wanted]
    if not force:
        want = [r for r in want if not r[2]]
    if not want:
        return
    bare = [r for r in want if "://" not in r[3]]
    if bare:
        raise FileNotFoundError(
            "no URL with a scheme for " + ", ".join(
                f"{r[0]} ({r[3]!r})" for r in bare)
            + f"; place the files in the cache dir {mroot}")
    os.makedirs(mroot, exist_ok=True)
    for name, _req, _installed, url in want:
        download(url, os.path.join(mroot, name), info, progress)


def Model(model, auto: bool = True):
    """Decorate an imported zoo package with source/list_source/download and
    (auto=True) download required files + call its load().

    Contract points existing zoo packages rely on (reference
    __init__.py:116-141): a static ``model.source`` list is upgraded to the
    callable form; manifest rows with an empty url default to
    ``<package path>/<name>``; ``model.root`` moves to the cache dir and any
    module whose own ``root`` global equaled the package's previous root is
    rebound too (package code builds file paths from that global)."""
    if hasattr(model, "list_source"):
        return model
    pkg = model.__package__
    cache_dir = os.path.join(root, *pkg.replace("planer_zoo.", "").split("."))
    if hasattr(model, "source") and not callable(model.source):
        manifest = [list(row) for row in model.source]
    else:
        manifest = get_source(
            model.__file__.replace("__init__.py", "readme.md"))
    for row in manifest:
        if row[-1] == "":
            row[-1] = pkg.replace(".", "/") + "/" + row[0]

    def _source():
        return source(cache_dir, manifest)

    def _list_source():
        return list_source(cache_dir, manifest)

    def _download(names="required", force=False, info=print,
                  progress=progress):
        return downloads(cache_dir, manifest, names, force, info, progress)

    old_root = getattr(model, "root", None)
    model.root = cache_dir
    if old_root is not None:
        seen = {inspect.getmodule(getattr(model, a)) for a in dir(model)}
        for mod in seen:
            if mod is not None and getattr(mod, "root", None) == old_root:
                mod.root = cache_dir
    model.source = _source
    model.list_source = _list_source
    model.download = _download
    if auto:
        model.download()
        model.load()
    return model


def load(name: str, auto: bool = True):
    return Model(importlib.import_module(name), auto)
