"""The port stands alone: neither `jax` nor anything of `tidb_tpu` enters
the process when it is imported, no source of the port or of
chip_smoke.py imports them, and the engine never picks the CPU on its own.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tidb_tpu_torch")


def _modules() -> list[str]:
    return sorted(["tidb_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], prefix="tidb_tpu_torch.")
    ])


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "tidb_tpu" or name.startswith("tidb_tpu.")


def test_importing_every_module_brings_in_neither_jax_nor_the_reference():
    mods = _modules()
    assert "tidb_tpu_torch.copr.gpu_engine" in mods and "tidb_tpu_torch.kernels.seg_agg" in mods
    for k in ("lex_sort", "topk", "topn_multi", "sort_groups", "window", "pack_flat", "lut_join", "run_agg",
              "block_topk", "sort_join", "seg_reduce", "rowpos_agg", "dense_agg", "red", "expr_eval", "q1_local",
              "hash_repartition", "grouped", "exchange", "compact"):
        assert f"tidb_tpu_torch.kernels.{k}" in mods
    for m in ("executor.window_device", "executor.window", "executor.mpp_gather", "parallel.mpp",
              "parallel.mpp_program", "planner.fragment", "expr.program", "parallel.mesh", "copr.retry",
              "sched.batcher", "sched.scheduler", "sched.resource_group", "utils.failpoint", "utils.metrics",
              "utils.tracing", "utils.timeline", "utils.memory", "utils.sem", "expr.builtins", "expr.builtins_ext",
              "expr.builtins_ext2", "expr.builtins_ext3", "expr._aes", "expr.sessioninfo", "mysqltypes.collate",
              "mysqltypes.coretime", "mysqltypes.datum", "mysqltypes.field_type", "mysqltypes.mydecimal",
              "codec.key", "codec.tablecodec", "codec.row", "codec.rowfast", "catalog.schema", "catalog.meta",
              "ddl.jobs", "table.table", "planner.ranger", "storage.memkv", "storage.tso", "storage.regions",
              "storage.detector", "storage.segment", "storage.mvcc", "storage.txn", "cdc", "br.ingest",
              "copr.tilecache", "parser", "parser.lexer", "parser.ast", "parser.parser", "statistics",
              "statistics.histogram", "statistics.cmsketch", "statistics.fmsketch", "statistics.tablestats",
              "statistics.selectivity", "statistics.handle", "planner.plans", "planner.builder",
              "planner.optimizer", "session.vars", "sched.runaway", "utils.stmtstats", "storage.gcworker",
              "executor.executors"):
        assert f"tidb_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tidb_tpu' or m.startswith('tidb_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for script in ("chip_smoke.py", "sort_profile.py", "k4_profile.py", "mpp_profile.py", "mesh_stress.py",
                   "expr_profile.py"):
        yield os.path.join(ROOT, script)


def test_no_source_imports_jax_or_the_reference():
    offenders = []
    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not offenders


def test_every_relative_import_of_the_port_resolves_inside_the_port():
    """No module of the port names a module the port does not have (the
    reference's lazy imports of modules outside a slice — the WAL, the
    compactor, the Session — are gone, not left to fail at run time)."""
    missing = []
    for path in _sources():
        if not path.startswith(PKG):
            continue
        pkg_parts = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
        for node in ast.walk(ast.parse(open(path, encoding="utf-8").read(), path)):
            if not isinstance(node, ast.ImportFrom) or node.level == 0:
                continue
            base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            targets = [base + node.module.split(".")] if node.module else [base + [a.name] for a in node.names]
            for t in targets:
                f = os.path.join(ROOT, *t)
                if not (os.path.isfile(f + ".py") or os.path.isfile(os.path.join(f, "__init__.py"))):
                    if node.module is None and os.path.isfile(os.path.join(ROOT, *base, "__init__.py")):
                        continue  # a name of the package itself
                    missing.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {'.'.join(t)}")
    assert not missing


def test_engine_without_a_device_argument_never_falls_back_to_cpu():
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.torchenv import resolve_device

    if torch.cuda.is_available():
        assert TorchEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TorchEngine()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")
    assert TorchEngine(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
