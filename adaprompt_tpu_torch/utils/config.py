"""Merged configuration files and dotlist overrides for the CLIs.

Port of `adaprompt_tpu/utils/config.py`: base YAML files merged left to
right (`--base`), then `key.sub=value` dotlist overrides (`--set`), then the
flags the user typed (highest precedence):

    python -m adaprompt_tpu_torch.cli.train --base s1.yaml s2.yaml \
        --set trainer.d_coef=0.5 data.bs=3 ... --max_steps 1000

YAML sections map onto the flat argparse namespace by their leaf name
(`trainer.d_coef` -> args.d_coef). `yaml` is imported only when a `--base`
file is read; without the package `--base` raises, and `--set` alone works.
"""

from __future__ import annotations

import argparse
from typing import Any


def _coerce(value: str) -> Any:
    """Parse a dotlist value like OmegaConf: bool/int/float/list/str."""
    s = value.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if "," in s:
        return [_coerce(p) for p in s.split(",")]
    return s


def merge_trees(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out


def load_config_tree(paths: list) -> dict:
    """Merge YAML files left-to-right (later wins)."""
    if not paths:
        return {}
    try:
        import yaml
    except ImportError:
        raise RuntimeError("--base config files need the 'yaml' package (PyYAML), which is not "
                           "installed here; pass the settings with --set key=value") from None
    tree: dict = {}
    for p in paths:
        with open(p) as f:
            doc = yaml.safe_load(f) or {}
        if not isinstance(doc, dict):
            raise ValueError(f"{p}: top level must be a mapping")
        tree = merge_trees(tree, doc)
    return tree


def apply_dotlist(tree: dict, dotlist: list) -> dict:
    """Apply `a.b.c=value` overrides onto the tree."""
    out = dict(tree)
    for item in dotlist or ():
        if "=" not in item:
            raise ValueError(f"dotlist entry {item!r} needs key=value")
        key, value = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
            node[p] = dict(nxt)
            node = node[p]
        node[parts[-1]] = _coerce(value)
    return out


def _flatten_leaves(tree: dict, out: dict):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten_leaves(v, out)
        else:
            out[k] = v


def add_config_args(parser: argparse.ArgumentParser):
    parser.add_argument("--base", type=str, nargs="*", default=[],
                        help="YAML config file(s), merged left-to-right "
                             "(merged left to right)")
    parser.add_argument("--set", dest="dotlist", type=str, nargs="*",
                        default=[],
                        help="dotlist overrides key.sub=value "
                             "(OmegaConf dotlist style)")


def apply_config_files(args: argparse.Namespace,
                       parser: argparse.ArgumentParser | None = None,
                       argv=None) -> argparse.Namespace:
    """Fold --base YAMLs + --set dotlist into `args`.

    Precedence (low -> high): argparse defaults < YAML files < dotlist <
    flags the user explicitly passed on the command line."""
    if not getattr(args, "base", None) and not getattr(args, "dotlist", None):
        return args
    tree = load_config_tree(args.base or [])
    tree = apply_dotlist(tree, args.dotlist or [])
    leaves: dict = {}
    _flatten_leaves(tree, leaves)

    explicit = set()
    if parser is not None and argv is not None:
        # flags the user typed override YAML; detect via a defaults-less parse
        sentinel = argparse.ArgumentParser(add_help=False)
        for action in parser._actions:
            if action.option_strings and action.dest not in ("help",):
                sentinel.add_argument(*action.option_strings,
                                      dest=action.dest, nargs="?",
                                      default=argparse.SUPPRESS)
        known, _ = sentinel.parse_known_args(argv)
        explicit = set(vars(known))

    for key, value in leaves.items():
        if hasattr(args, key) and key not in explicit:
            setattr(args, key, value)
    unknown = [k for k in leaves if not hasattr(args, k)]
    if unknown:
        print(f"config: ignoring unknown keys {unknown}")
    return args
