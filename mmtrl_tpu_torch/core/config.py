"""Config dataclasses with a CleanRL-flag-compatible argparse bridge; the
port's own copy of ``mmtrl_tpu/core/config.py``.

Each trainer declares one ``@dataclass`` of typed fields and :func:`cli`
builds the reference's ``--kebab-case`` flags from it (reference:
src/utils.py:47-129), with CleanRL's ``strtobool`` booleans (``--cuda
False`` and a bare ``--track`` both work).  The JAX module's
``enable_compile_cache`` and ``--platform`` handling configure JAX's
compilation cache and backend; they have no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Optional, Sequence, Type, TypeVar

T = TypeVar("T")

_TRUTHY = {"y", "yes", "t", "true", "on", "1"}
_FALSY = {"n", "no", "f", "false", "off", "0"}


def strtobool(value: str) -> bool:
    """CleanRL-compatible boolean parsing (distutils.util.strtobool)."""
    v = value.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise argparse.ArgumentTypeError(f"invalid truth value {value!r}")


def flag_name(field_name: str) -> str:
    return "--" + field_name.replace("_", "-")


def _add_field(parser: argparse.ArgumentParser, field: dataclasses.Field) -> None:
    name = flag_name(field.name)
    help_text = field.metadata.get("help", "")
    default = (
        field.default
        if field.default is not dataclasses.MISSING
        else field.default_factory()  # type: ignore[misc]
    )
    ftype = field.type if not isinstance(field.type, str) else eval(field.type)  # noqa: S307
    origin = getattr(ftype, "__origin__", None)
    if ftype is bool or (origin is not None and bool in getattr(ftype, "__args__", ())):
        # `--flag`, `--flag True`, `--flag false` (reference: src/utils.py:54-58)
        parser.add_argument(name, type=strtobool, default=default, nargs="?", const=True,
                            help=help_text)
    elif origin in (list, tuple) or ftype in (list, tuple):
        args = getattr(ftype, "__args__", (str,))
        parser.add_argument(name, type=args[0], nargs="+", default=default, help=help_text)
    elif origin is not None and type(None) in getattr(ftype, "__args__", ()):
        # Optional[X]: argparse keeps the None default when the flag is absent.
        inner = [a for a in ftype.__args__ if a is not type(None)][0]
        parser.add_argument(name, type=inner, default=default, help=help_text)
    else:
        parser.add_argument(name, type=ftype, default=default, help=help_text)


def cli(config_cls: Type[T], argv: Optional[Sequence[str]] = None) -> T:
    """Parse CLI flags (``sys.argv[1:]`` when ``argv`` is None) into an
    instance of ``config_cls``; its ``__post_init__``, if any, runs as
    usual."""
    parser = argparse.ArgumentParser()
    fields = [f for f in dataclasses.fields(config_cls)
              if f.init and not f.metadata.get("derived", False)]
    for field in fields:
        _add_field(parser, field)
    ns = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    return config_cls(**{f.name: getattr(ns, f.name) for f in fields})


def asdict_flat(config: Any) -> dict[str, Any]:
    """Flat dict of a config for hyperparameter logging tables."""
    return dataclasses.asdict(config)
