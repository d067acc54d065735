"""Serving's view of the shared fault registry (:mod:`..faults`), under
the import path the reference's serving package uses."""

from __future__ import annotations

from ..faults import (  # noqa: F401
    SERVING_SITES,
    SITES,
    TRAINING_SITES,
    FaultError,
    FaultInjector,
    FaultSpec,
)

__all__ = [
    "SERVING_SITES",
    "SITES",
    "TRAINING_SITES",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
]
