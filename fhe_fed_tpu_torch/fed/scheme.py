"""Abstract secure-aggregation scheme API + registry.

Parity with the reference's Scheme ABC (include/scheme.h:15-32): the same
five operations, as a Python protocol. The *_cpp flavors in the reference
bind to the same methods (binding.cpp:27-31), mirrored here as aliases.
"""

from __future__ import annotations

import abc

import numpy as np

_REGISTRY: dict[str, type] = {}


def register_scheme(name: str):
    def deco(cls):
        _REGISTRY[name.lower()] = cls
        return cls
    return deco


def get_scheme(name: str) -> type:
    return _REGISTRY[name.lower()]


class Scheme(abc.ABC):
    """Secure-aggregation scheme: keygen/load, encrypt, weighted-average,
    decrypt (reference scheme.h:23-30)."""

    def __init__(self, scheme: str):
        self.scheme = scheme

    @abc.abstractmethod
    def loadCryptoParams(self) -> None: ...

    @abc.abstractmethod
    def genCryptoContextAndKeyGen(self) -> int: ...

    @abc.abstractmethod
    def encrypt(self, data_array: np.ndarray) -> bytes: ...

    @abc.abstractmethod
    def computeWeightedAverage(self, learner_data: list[bytes],
                               scaling_factors: list[float]) -> bytes: ...

    @abc.abstractmethod
    def decrypt(self, learner_data: bytes,
                data_dimensions: int) -> np.ndarray: ...

    # The reference binds the _cpp names to the same implementations
    # (binding.cpp:27-31).
    def encrypt_cpp(self, data) -> bytes:
        return self.encrypt(np.asarray(data))

    def computeWeightedAverage_cpp(self, learners_data, scaling_factors):
        return self.computeWeightedAverage(list(learners_data),
                                           list(scaling_factors))

    def decrypt_cpp(self, learner_data: bytes, data_dimensions: int):
        return self.decrypt(learner_data, data_dimensions)
