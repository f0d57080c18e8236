"""Name-keyed component registries.

The reference resolves model components by string from config via
``getattr(generateNet, 'generate' + name)`` (reference: training.py:240-241,
infer.py:91-93). That is a good extension point; here it is an explicit
registry with error reporting instead of module-attribute reflection.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self._kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str, item: T | None = None):
        """Register ``item`` under ``name``; usable as a decorator."""
        if item is not None:
            self._items[name] = item
            return item

        def deco(fn: T) -> T:
            self._items[name] = fn
            return fn

        return deco

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            known = ", ".join(sorted(self._items)) or "<none>"
            raise KeyError(
                f"Unknown {self._kind} {name!r}. Registered: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self) -> list[str]:
        return sorted(self._items)


# Global registries mirroring the reference's leg/head/model string keys
# (config/network.yml:64-82).
LEGS: Registry[Callable] = Registry("legs type")
HEADS: Registry[Callable] = Registry("head type")
MODELS: Registry[Callable] = Registry("model type")
