"""Shared launcher argparse plumbing — the JAX package's ``launch/_args.py``.

Both launchers (``repro_torch.launch.train``, ``repro_torch.launch.serve``)
and the dry run (``repro_torch.launch.dryrun``) take the compression plan
as ``--comm-spec`` with ``--policy`` as a deprecated alias.  The alias is
resolved in exactly one place: a DeprecationWarning fires only when
``--policy`` was passed (its argparse default is None), and an explicit
``--comm-spec`` always wins over the alias.
"""
from __future__ import annotations

import warnings

DEFAULT_SPEC = "taco"


def add_policy_alias(ap) -> None:
    """Register the deprecated ``--policy`` alias (default None, so that
    :func:`resolve_comm_spec` can tell 'passed' from 'defaulted')."""
    ap.add_argument("--policy", default=None,
                    help="deprecated alias for --comm-spec")


def resolve_comm_spec(args, default: str = DEFAULT_SPEC) -> str:
    """The effective comm spec string of parsed launcher args:
    explicit ``--comm-spec`` > explicit ``--policy`` (with a
    DeprecationWarning) > ``default``."""
    if getattr(args, "policy", None) is not None:
        warnings.warn("--policy is deprecated; use --comm-spec",
                      DeprecationWarning, stacklevel=2)
        if args.comm_spec is None:
            return args.policy
    return args.comm_spec if args.comm_spec is not None else default
