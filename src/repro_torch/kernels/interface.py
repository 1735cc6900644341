"""Kernel dispatch interface: ops, variants, and spec-string parsing.

The ``model.kernels`` grammar and its strings are the reference
package's, so one ``RunSpec`` JSON drives both packages:

    "auto"                          per-device default for every op
    "pallas" / "xla"                one variant for every op
    "attention=pallas,ssm_scan=xla_associative"
                                    per-op overrides (unlisted ops stay
                                    on the global default, "auto" unless
                                    a bare token set one)
    "xla,ssm_scan=pallas"           bare token + overrides compose

What the strings mean in the port:

    "pallas"   the hand-written Hopper kernel (``KernelType.KERNEL``);
               on a CPU tensor the kernel wrapper takes its plain
               version, because no kernel runs there
    "xla"      the plain PyTorch formulation (``KernelType.PLAIN``)
    "auto"     by the tensor's device: the kernel on CUDA, plain on
               the CPU

``ssm_scan`` stays in the table so that the grammar validates exactly as
the reference's does; the port runs no SSM yet (ROADMAP queue 1, item
10).  Importing this module never imports torch.
"""

from __future__ import annotations

import enum
from typing import Dict


class KernelType(enum.Enum):
    KERNEL = 0              # the hand-written Hopper kernel
    PLAIN = 1               # the plain PyTorch formulation
    PLAIN_ASSOCIATIVE = 2   # associative-scan formulation (ssm_scan)


#: spec-string token -> enum member.
KernelTypeMapping: Dict[str, KernelType] = {
    "pallas": KernelType.KERNEL,
    "xla": KernelType.PLAIN,
    "xla_associative": KernelType.PLAIN_ASSOCIATIVE,
}

AUTO = "auto"

#: Registry surface: op name -> the variant tokens it implements.
OPS: Dict[str, tuple] = {
    "attention": ("pallas", "xla"),
    "rmsnorm": ("pallas", "xla"),
    "residual_rmsnorm": ("pallas", "xla"),
    "ssm_scan": ("pallas", "xla", "xla_associative"),
}

#: "auto" resolution per device: the kernels on CUDA, the plain
#: formulations on the CPU.
_AUTO_CUDA: Dict[str, str] = {op: "pallas" for op in OPS}
_AUTO_CPU: Dict[str, str] = {
    "attention": "xla",
    "rmsnorm": "xla",
    "residual_rmsnorm": "xla",
    "ssm_scan": "xla_associative",
}


def valid_overrides() -> str:
    """Human-readable per-op override table for error messages."""
    return ", ".join(f"{op}={{{'|'.join(vs)}}}" for op, vs in OPS.items())


def parse_kernels(spec: str) -> Dict[str, str]:
    """Parse a ``model.kernels`` string into {op: variant-or-'auto'}.

    Returns a FULL mapping (every op present).  Raises ``ValueError``
    with a message listing the valid per-op overrides on any unknown
    op, unknown variant, or a variant an op does not implement.
    """
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(
            "model.kernels must be a non-empty string: 'auto', a "
            f"variant ({'/'.join(KernelTypeMapping)}), or per-op "
            f"overrides ({valid_overrides()})")
    chosen = {op: AUTO for op in OPS}
    for token in spec.split(","):
        token = token.strip()
        if not token:
            raise ValueError(
                f"model.kernels={spec!r} has an empty entry; valid "
                f"per-op overrides: {valid_overrides()}")
        if "=" not in token:
            if token != AUTO and token not in KernelTypeMapping:
                raise ValueError(
                    f"model.kernels variant {token!r} is unknown; use "
                    f"'auto', {'/'.join(KernelTypeMapping)}, or per-op "
                    f"overrides ({valid_overrides()})")
            for op, variants in OPS.items():
                if token == AUTO or token in variants:
                    chosen[op] = token
                else:
                    raise ValueError(
                        f"model.kernels={token!r} does not apply to "
                        f"every op ({op} implements only "
                        f"{'/'.join(variants)}); use per-op overrides: "
                        f"{valid_overrides()}")
            continue
        op, _, variant = token.partition("=")
        op, variant = op.strip(), variant.strip()
        if op not in OPS:
            raise ValueError(
                f"model.kernels names unknown op {op!r}; valid per-op "
                f"overrides: {valid_overrides()}")
        if variant != AUTO and variant not in OPS[op]:
            raise ValueError(
                f"model.kernels: op {op!r} has no variant {variant!r} "
                f"(it implements {'/'.join(OPS[op])}); valid per-op "
                f"overrides: {valid_overrides()}")
        chosen[op] = variant
    return chosen


def resolve(spec: str, op: str, *, cuda: bool) -> KernelType:
    """The variant a spec string selects for ``op`` on a tensor that
    lives on CUDA (``cuda=True``) or on the CPU."""
    if op not in OPS:
        raise ValueError(f"unknown registry op {op!r}; registry ops: "
                         f"{sorted(OPS)}")
    variant = parse_kernels(spec)[op]
    if variant == AUTO:
        variant = (_AUTO_CUDA if cuda else _AUTO_CPU)[op]
    return KernelTypeMapping[variant]
