"""Runtime environments: per-task/actor working_dir, py_modules, env_vars.

Parity: ``python/ray/_private/runtime_env/`` — the reference packages
``working_dir``/``py_modules`` into content-addressed zips stored in the GCS
KV (``working_dir.py:1``, ``packaging.py``) and a per-node agent materializes
them before the worker runs. Here the driver uploads the zip to the cluster
KV at submission; workers download + extract once per package (cached by
content hash) and apply chdir/sys.path around execution.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import tempfile
import zipfile
from typing import Optional

_PKG_NS = "runtime_env_packages"
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_PKG_BYTES = 100 * 1024 * 1024


def package_directory(path: str) -> tuple[str, bytes]:
    """Zip ``path`` deterministically; returns (content_hash, zip_bytes)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory {path!r} does not exist")
    buf = io.BytesIO()
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in sorted(files):
            if f.endswith(".pyc"):
                continue
            full = os.path.join(root, f)
            entries.append((os.path.relpath(full, path), full))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            # fixed timestamp -> deterministic hash for identical content
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            with open(full, "rb") as fh:
                zf.writestr(info, fh.read())
    blob = buf.getvalue()
    if len(blob) > _MAX_PKG_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(blob)} bytes "
            f"(limit {_MAX_PKG_BYTES}); add excludes or trim the directory"
        )
    return hashlib.sha256(blob).hexdigest()[:24], blob


# driver-side packaging memo: abspath -> digest (a path's contents are
# assumed stable within one driver session, like the reference's URI cache)
_upload_cache: dict = {}


def _upload_path(rt, path: str) -> str:
    key = os.path.abspath(path)
    digest = _upload_cache.get(key)
    if digest is None:
        digest, blob = package_directory(key)
        rt.rpc("kv_put", _PKG_NS, digest.encode(), blob, False)
        _upload_cache[key] = digest
    return digest


def upload_runtime_env(rt, runtime_env: Optional[dict]) -> Optional[dict]:
    """Driver-side: replace local paths with content-addressed URIs, storing
    packages in the cluster KV (idempotent by hash, memoized per path so
    per-call submission stays cheap)."""
    if not runtime_env:
        return runtime_env
    out = dict(runtime_env)
    wd = out.pop("working_dir", None)
    if wd:
        out["working_dir_uri"] = _upload_path(rt, wd)
    mods = out.pop("py_modules", None)
    if mods:
        out["py_modules_uris"] = [
            (os.path.basename(os.path.abspath(m)), _upload_path(rt, m))
            for m in mods
        ]
    return out


def _materialize_package(rt, digest: str, subdir_name: str = "") -> str:
    """Worker-side: fetch + extract a package once; returns the local dir.

    Extraction is atomic (temp dir + rename) so concurrent workers never see
    a half-extracted tree, and the target is keyed by (digest, layout) so a
    digest used both as working_dir and as a py_module gets both layouts."""
    layout = subdir_name or "_wd"
    target = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_pkgs", digest, layout)
    if not os.path.isdir(target):
        blob = rt.rpc("kv_get", _PKG_NS, digest.encode())
        if blob is None:
            raise RuntimeError(f"runtime_env package {digest} not in cluster KV")
        tmp = target + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, target)
        except OSError:
            # another worker won the race; its fully-extracted copy stands
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return target


def _materialize_pip_env(packages: list) -> str:
    """Install a pip package set into a content-addressed target dir (cached).

    Parity: ``python/ray/_private/runtime_env/pip.py`` — per-env installed
    package sets activated for the task. This environment has no network
    egress, so installation runs ``--no-index`` against a local wheelhouse
    (``RAY_TPU_TORCH_WHEELHOUSE``, default ``ray_tpu_torch_wheelhouse`` under the
    temporary directory); the
    reference's online index mode is the same command without the flags.
    """
    import subprocess

    import shutil

    pkgs = sorted(str(p) for p in packages)
    wheelhouse = os.environ.get(
        "RAY_TPU_TORCH_WHEELHOUSE",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch_wheelhouse"),
    )
    # digest covers the wheelhouse too: the same package names resolved from
    # a different wheelhouse must not reuse a stale install
    digest = hashlib.sha256(
        "\n".join(pkgs + ["@" + os.path.abspath(wheelhouse)]).encode()
    ).hexdigest()[:24]
    target = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_pip_envs", digest)
    if os.path.isdir(os.path.join(target, ".done")):
        return target
    tmp = target + f".tmp.{os.getpid()}"
    # dependencies resolve from the same wheelhouse (--no-index keeps the
    # whole resolution offline)
    cmd = [
        sys.executable, "-m", "pip", "install", "--quiet",
        "--no-index", "--find-links", wheelhouse,
        "--target", tmp, *pkgs,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"pip runtime_env install failed for {pkgs} "
                f"(wheelhouse {wheelhouse}): {proc.stderr.strip()[-500:]}"
            )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    os.makedirs(os.path.join(tmp, ".done"), exist_ok=True)
    try:
        os.rename(tmp, target)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def apply(rt, runtime_env: dict):
    """Apply env_vars/pip/working_dir/py_modules; returns a restore token."""
    saved = {"env": {}, "cwd": None, "sys_path": []}
    try:
        env = runtime_env.get("env_vars") or {}
        for k, v in env.items():
            saved["env"][k] = os.environ.get(k)
            os.environ[k] = str(v)
        # after env_vars: RAY_TPU_TORCH_WHEELHOUSE may arrive through them
        pip_pkgs = runtime_env.get("pip")
        if pip_pkgs:
            pip_dir = _materialize_pip_env(pip_pkgs)
            sys.path.insert(0, pip_dir)
            saved["sys_path"].append(pip_dir)
        wd_uri = runtime_env.get("working_dir_uri")
        if wd_uri:
            wd = _materialize_package(rt, wd_uri)
            saved["cwd"] = os.getcwd()
            os.chdir(wd)
            sys.path.insert(0, wd)
            saved["sys_path"].append(wd)
        for name, digest in runtime_env.get("py_modules_uris") or []:
            mod_dir = _materialize_package(rt, digest, subdir_name=name)
            parent = os.path.dirname(mod_dir)
            if parent not in sys.path:
                sys.path.insert(0, parent)
                saved["sys_path"].append(parent)
    except BaseException:
        # a half-applied env must not leak into later tasks on this worker
        restore(saved)
        raise
    return saved


def restore(saved):
    for k, v in saved.get("env", {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if saved.get("cwd"):
        try:
            os.chdir(saved["cwd"])
        except OSError:
            pass
    for p in saved.get("sys_path", []):
        try:
            sys.path.remove(p)
        except ValueError:
            pass
