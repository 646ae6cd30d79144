"""Runtime environments: per-task/actor env_vars, py_modules, working_dir.

reference: python/ray/_private/runtime_env/ — envs are applied to DEDICATED
worker processes (the raylet's WorkerPool keys workers by runtime-env hash
and starts new ones with the env baked in), packages are content-addressed
URIs cached in the GCS KV (uri_cache.py), and the per-node agent
materializes them before the lease is granted.  Here the materialization
runs in the worker bootstrap (workers_main) — same contract, one fewer
process.

Supported fields (the reference's core trio):
  env_vars:    {name: value} exported before user code runs
  py_modules:  local dirs/files zipped to the GCS KV (kv://pymod:<sha>),
               extracted on the worker, prepended to sys.path
  working_dir: local dir zipped likewise, extracted + chdir'd
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile
import zipfile
from typing import Any, Dict, Optional

_KV_PREFIX = "kv://"


_SUPPORTED = ("env_vars", "py_modules", "working_dir", "pip", "uv",
              "worker_process_setup_hook")


def normalize(runtime_env: Optional[dict]) -> Optional[dict]:
    """Canonical form; None for empty (no dedicated worker needed)."""
    if not runtime_env:
        return None
    out = {}
    for key in _SUPPORTED:
        if runtime_env.get(key):
            out[key] = runtime_env[key]
    unknown = set(runtime_env) - set(_SUPPORTED)
    if unknown:
        raise ValueError(f"unsupported runtime_env fields: {sorted(unknown)}")
    if "pip" in out:
        pip = out["pip"]
        if isinstance(pip, dict):  # reference accepts {"packages": [...]}
            pip = pip.get("packages", [])
        if isinstance(pip, str):
            raise ValueError(
                "runtime_env['pip'] must be a list of requirement strings "
                "(requirements-file paths are not supported: the image is "
                "immutable, so this field validates rather than installs)")
        out["pip"] = sorted(str(p) for p in pip)
    if "uv" in out:
        uv = out["uv"]
        find_links = None
        if isinstance(uv, dict):  # reference uv field accepts {"packages"}
            find_links = uv.get("find_links")
            uv = uv.get("packages", [])
        if isinstance(uv, str):
            raise ValueError(
                "runtime_env['uv'] must be a list of requirement strings "
                "or {'packages': [...], 'find_links': dir}")
        if isinstance(runtime_env.get("uv"), dict):
            unknown_uv = set(runtime_env["uv"]) - {"packages", "find_links"}
            if unknown_uv:
                raise ValueError(
                    f"unsupported runtime_env['uv'] keys: {sorted(unknown_uv)}"
                    " (supported: packages, find_links)")
        if not uv:
            raise ValueError(
                "runtime_env['uv'] needs a non-empty 'packages' list")
        spec = {"packages": sorted(str(p) for p in uv)}
        if find_links:
            spec["find_links"] = str(find_links)
        out["uv"] = spec
    hook = out.get("worker_process_setup_hook")
    if hook is not None and not (
            callable(hook)
            or (isinstance(hook, dict) and hook.get("kv"))
            or (isinstance(hook, str) and hook.startswith(_KV_PREFIX))):
        raise ValueError(
            "runtime_env['worker_process_setup_hook'] must be a callable "
            "(it is shipped through the function registry and run once per "
            "worker before its first task), or an already-packaged kv:// "
            "function URI")
    return out or None


def check_pip_requirements(packages) -> None:
    """This deployment's images are IMMUTABLE (decision recorded in
    PARITY.md): runtime_env["pip"] VALIDATES that the requirements are
    already satisfied by the baked image instead of installing — a missing
    or mismatched package fails worker setup with a clear error rather
    than silently running against the wrong environment (reference:
    _private/runtime_env/pip.py installs; same user-visible contract of
    "my task ran with these packages or it didn't run")."""
    import importlib.metadata as im

    try:
        from packaging.requirements import InvalidRequirement, Requirement
        from packaging.version import Version
    except ImportError:  # presence-only fallback
        Requirement = None

    problems = []
    for req in packages:
        req = str(req)
        if Requirement is None:
            name = req.split(";")[0].split("[")[0]
            for sep in ("==", ">=", "<=", "~=", "!=", ">", "<"):
                name = name.split(sep)[0]
            try:
                im.version(name.strip())
            except im.PackageNotFoundError:
                problems.append(f"{name.strip()}: not installed in the immutable image")
            continue
        try:
            r = Requirement(req)
        except InvalidRequirement as e:
            problems.append(f"{req!r}: unparseable requirement ({e})")
            continue
        try:
            have = im.version(r.name)
        except im.PackageNotFoundError:
            problems.append(f"{r.name}: not installed in the immutable image")
            continue
        if r.specifier and not r.specifier.contains(Version(have), prereleases=True):
            problems.append(f"{r.name}: image has {have}, requirement is {r.specifier}")
    if problems:
        raise RuntimeError(
            "runtime_env['pip'] cannot install into the immutable TPU image; "
            "these requirements are unsatisfied: " + "; ".join(problems)
            + ". Bake them into the image or drop the pin.")


def materialize_uv_env(spec: dict) -> str:
    """Create (or reuse) an ephemeral uv venv for ``spec`` and return its
    site-packages dir (VERDICT r4 missing #1; reference capability:
    _private/runtime_env/uv.py / pip.py:45 build real per-env virtualenvs).

    Zero-egress images: uv resolves offline from its local wheel cache
    plus an optional ``find_links`` wheel directory (spec field, or the
    ``RAY_TPU_UV_FIND_LINKS`` env var).  The env is cached under a content
    hash and shared by every worker in the env's pool; concurrent
    materializations race safely via build-then-atomic-rename.

    If resolution fails BUT the immutable image already satisfies every
    requirement, the baked versions are used (validate-only fallback —
    the reference's behavior when an env is a no-op); otherwise a clear
    worker-setup error surfaces both failures.
    """
    import subprocess

    packages = spec.get("packages") or []
    if not packages:
        return ""
    # the EFFECTIVE wheel source is part of the identity: a changed
    # RAY_TPU_UV_FIND_LINKS must not silently reuse a stale venv
    find_links = (spec.get("find_links")
                  or os.environ.get("RAY_TPU_UV_FIND_LINKS"))
    key = hashlib.sha1(json.dumps(
        {"packages": list(packages), "find_links": find_links},
        sort_keys=True).encode()).hexdigest()[:16]
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_uv_envs")
    dest = os.path.join(base, key)

    def site_dir(venv: str) -> str:
        v = f"python{sys.version_info.major}.{sys.version_info.minor}"
        return os.path.join(venv, "lib", v, "site-packages")

    if os.path.exists(os.path.join(dest, ".validate_only")):
        return ""  # cached negative: baked image satisfies the pins
    if os.path.exists(os.path.join(dest, ".ready")):
        return site_dir(dest)
    os.makedirs(base, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=".uv-build-", dir=base)

    def publish(marker: str) -> bool:
        open(os.path.join(staging, marker), "w").close()
        try:
            os.rename(staging, dest)
            return True
        except OSError:  # concurrent build published first
            import shutil

            shutil.rmtree(staging, ignore_errors=True)
            return False

    def published_result() -> str:
        """Resolve against whatever a CONCURRENT build published: losing
        the rename race must adopt the winner's verdict, not return this
        build's (now-deleted) staging dir.  A published dest always
        carries a marker (publish() writes it before the rename):
        ``.ready`` → the winner's venv; ``.validate_only`` → the winner
        proved the baked image satisfies the pins, so use it ('').  A
        markerless dest means the rename failed for a NON-race reason
        (e.g. a tmp cleaner pruned the parent) — fail loudly rather than
        silently run against the baked image unvalidated."""
        if os.path.exists(os.path.join(dest, ".ready")):
            return site_dir(dest)
        if os.path.exists(os.path.join(dest, ".validate_only")):
            return ""
        raise RuntimeError(
            f"runtime_env['uv'] could not publish the built environment "
            f"to {dest} and no concurrent build published one either — "
            "is the temp directory being cleaned concurrently?")

    def peer_ready() -> Optional[str]:
        """A peer's finished venv, if one was published while we failed."""
        if os.path.exists(os.path.join(dest, ".ready")):
            import shutil

            shutil.rmtree(staging, ignore_errors=True)
            return site_dir(dest)
        return None

    try:
        subprocess.run(["uv", "venv", "--quiet", staging], check=True,
                       capture_output=True, text=True, timeout=120)
        install = ["uv", "pip", "install", "--quiet",
                   "--python", os.path.join(staging, "bin", "python"),
                   "--offline"]
        if find_links:
            install += ["--find-links", find_links]
        install += list(packages)
        p = subprocess.run(install, capture_output=True, text=True,
                           timeout=600)
        if p.returncode != 0:
            # offline resolution failed: accept a peer's finished venv, or
            # the baked image IF it already satisfies the pins, else
            # surface both failures
            peer = peer_ready()
            if peer is not None:
                return peer
            try:
                check_pip_requirements(packages)
            except RuntimeError as image_err:
                peer = peer_ready()  # a peer may have published meanwhile
                if peer is not None:
                    return peer
                raise RuntimeError(
                    "runtime_env['uv'] could not build the environment: uv "
                    f"failed ({(p.stderr or p.stdout).strip()[-400:]}) and "
                    f"the immutable image does not satisfy the pins "
                    f"({image_err}). Provide a wheel directory via "
                    "find_links / RAY_TPU_UV_FIND_LINKS, or bake the "
                    "packages into the image.") from None
            # cache the negative so the rest of the pool skips the doomed
            # venv+install at bootstrap
            if publish(".validate_only"):
                return ""
            return published_result()
        if publish(".ready"):
            return site_dir(dest)
        return published_result()
    except subprocess.CalledProcessError as e:
        import shutil

        peer = peer_ready()
        if peer is not None:
            return peer
        shutil.rmtree(staging, ignore_errors=True)
        raise RuntimeError(
            "runtime_env['uv'] venv creation failed: "
            f"{(e.stderr or e.stdout or str(e)).strip()[-400:]}") from None
    except (subprocess.TimeoutExpired, FileNotFoundError) as e:
        import shutil

        peer = peer_ready()
        if peer is not None:
            return peer
        shutil.rmtree(staging, ignore_errors=True)
        raise RuntimeError(
            f"runtime_env['uv'] setup failed: {e} — is uv on PATH?"
        ) from None


def env_hash(runtime_env: Optional[dict]) -> str:
    """Stable content hash; '' = the default (env-less) worker pool."""
    if not runtime_env:
        return ""
    blob = json.dumps(runtime_env, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def path_fingerprint(path: str) -> str:
    """Cheap content fingerprint (relpath, size, mtime_ns per file) — the
    driver's cache key for packaged local dirs; avoids re-zipping unchanged
    trees on every submission while still catching edits."""
    h = hashlib.sha1()
    if os.path.isfile(path):
        st = os.stat(path)
        h.update(f"{os.path.basename(path)}:{st.st_size}:{st.st_mtime_ns}".encode())
    else:
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for fname in sorted(files):
                full = os.path.join(root, fname)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                rel = os.path.relpath(full, path)
                h.update(f"{rel}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def _zip_path(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            base = os.path.basename(os.path.normpath(path))
            for root, _, files in os.walk(path):
                for fname in files:
                    full = os.path.join(root, fname)
                    rel = os.path.join(base, os.path.relpath(full, path))
                    zf.write(full, rel)
    return buf.getvalue()


def package(worker, runtime_env: Optional[dict]) -> Optional[dict]:
    """Driver-side: upload local py_modules/working_dir to the GCS KV and
    rewrite the env to content-addressed URIs (reference: uri_cache.py)."""
    runtime_env = normalize(runtime_env)
    if runtime_env is None:
        return None
    out = dict(runtime_env)

    def upload(path: str) -> str:
        data = _zip_path(path)
        sha = hashlib.sha1(data).hexdigest()[:16]
        key = f"pymod:{sha}"
        if not worker.gcs.call("KVExists", {"key": key}):
            worker.gcs.call("KVPut", {"key": key, "value": data})
        return f"{_KV_PREFIX}{key}"

    if "py_modules" in out:
        mods = []
        for m in out["py_modules"]:
            mods.append(upload(m) if not str(m).startswith(_KV_PREFIX) else m)
        out["py_modules"] = mods
    wd = out.get("working_dir")
    if wd and not str(wd).startswith(_KV_PREFIX):
        out["working_dir"] = upload(wd)
    hook = out.get("worker_process_setup_hook")
    if callable(hook):
        # Ship the callable through the function registry (the same fn:<sha>
        # KV namespace task functions use), so the spawned worker fetches it
        # once and the env stays a JSON-serializable pool key (the raylet
        # hashes it and exports it via RAY_TPU_RUNTIME_ENV).
        out["worker_process_setup_hook"] = {
            "kv": _KV_PREFIX + publish_setup_hook(worker, hook)}
    return out


def publish_setup_hook(worker, hook) -> str:
    """Serialize + publish a setup-hook callable; returns its fn:<sha> key."""
    from ray_tpu_torch._private import serialization

    blob = serialization.dumps_inline(hook)
    key = f"fn:{hashlib.sha1(blob).hexdigest()}"
    if not worker.gcs.call("KVExists", {"key": key}):
        worker.gcs.call("KVPut", {"key": key, "value": blob})
    return key


def _materialize(gcs_client, uri: str) -> str:
    """Fetch kv://pymod:<sha> into a cached extract dir; returns the dir.
    Concurrent workers race safely: extract to a private temp dir, then
    publish with one atomic rename (first one wins)."""
    key = uri[len(_KV_PREFIX):]
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_runtime_env")
    dest = os.path.join(base, key.replace(":", "_"))
    if os.path.exists(dest):
        return dest
    data = gcs_client.call("KVGet", {"key": key})
    if data is None:
        raise RuntimeError(f"runtime_env package {uri} not found in GCS KV")
    os.makedirs(base, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=".staging-", dir=base)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(staging)
    try:
        os.rename(staging, dest)
    except OSError:  # another worker published first; use theirs
        import shutil

        shutil.rmtree(staging, ignore_errors=True)
    return dest


def apply_in_worker(gcs_client, runtime_env: Optional[dict]):
    """Worker bootstrap: export env_vars, materialize packages, set paths.
    Runs once per (dedicated) worker process before user code."""
    if not runtime_env:
        return
    if runtime_env.get("pip"):
        check_pip_requirements(runtime_env["pip"])
    for name, value in (runtime_env.get("env_vars") or {}).items():
        os.environ[name] = str(value)
    if runtime_env.get("uv"):
        site = materialize_uv_env(runtime_env["uv"])
        if site:
            # in-process activation: the venv's site-packages shadows the
            # baked image for this dedicated worker (workers fork off the
            # zygote, so re-exec'ing into the venv python would forfeit
            # the warm start; path-precedence activation is how .pth-based
            # virtualenv activation works anyway).  Runs AFTER env_vars so
            # a user-supplied PYTHONPATH is merged behind the venv, not
            # clobbering it.
            sys.path.insert(0, site)
            os.environ["PYTHONPATH"] = (
                site + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for uri in runtime_env.get("py_modules") or ():
        # a py_module dir is importable by its basename (reference semantics)
        root = _materialize(gcs_client, uri)
        if root not in sys.path:
            sys.path.insert(0, root)
    wd = runtime_env.get("working_dir")
    if wd:
        root = _materialize(gcs_client, wd)
        entries = os.listdir(root)
        target = (os.path.join(root, entries[0])
                  if len(entries) == 1 and os.path.isdir(os.path.join(root, entries[0]))
                  else root)
        sys.path.insert(0, target)
        os.chdir(target)
    hook = runtime_env.get("worker_process_setup_hook")
    if hook:
        # Runs ONCE per worker process, after every other env field is in
        # place (env_vars exported, py_modules/working_dir on sys.path) and
        # BEFORE the worker registers for its first task (reference:
        # ray.init(runtime_env={"worker_process_setup_hook": fn}) —
        # _private/runtime_env/setup_hook.py ships the callable via the
        # function manager).  A raising hook fails worker setup loudly, so
        # leases surface the error instead of running half-configured.
        from ray_tpu_torch._private import serialization

        if callable(hook):
            fn = hook  # same-process application (driver-mode envs, tests)
        else:
            uri = hook["kv"] if isinstance(hook, dict) else hook
            blob = gcs_client.call("KVGet", {"key": uri[len(_KV_PREFIX):]})
            if blob is None:
                raise RuntimeError(
                    f"worker_process_setup_hook {uri} not found in GCS KV")
            fn = serialization.loads_inline(blob)
        fn()
