"""Name → object registry; a copy of the JAX package's `utils/registry.py`
(the reference's utils/registry.py, present there but unused). Nothing in
the port calls it either."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any):
        if name in self._obj_map:
            raise KeyError(f"An object named '{name}' was already registered in '{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj: Optional[Any] = None) -> Callable:
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class)
                return func_or_class

            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"No object named '{name}' found in '{self._name}' registry!")
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()

