"""A configuration that travels with a checkpoint directory.

Mirrors samplenet_tpu/utils/config.py (the reconstruction track's
Configuration, reconstruction/src/autoencoder.py:26-108): attribute
access over a dict, `exists_and_is_not_none`, and save / load as JSON
(<dir>/<name>.json, indented, keys sorted) beside the checkpoint, the
JAX module's format, so that either package reads the other's file.
"""

from __future__ import annotations

import json
import os
from typing import Any


class Configuration:
    def __init__(self, **kwargs: Any):
        self.__dict__["_values"] = dict(kwargs)

    def __getattr__(self, name: str) -> Any:
        values = self.__dict__["_values"]
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self.__dict__["_values"][name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__["_values"]

    def exists_and_is_not_none(self, name: str) -> bool:
        return self.__dict__["_values"].get(name) is not None

    def as_dict(self) -> dict:
        return dict(self.__dict__["_values"])

    def update(self, **kwargs: Any) -> "Configuration":
        self.__dict__["_values"].update(kwargs)
        return self

    def save(self, dir_path: str, name: str = "configuration") -> str:
        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, f"{name}.json")
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, default=str,
                      sort_keys=True)
        return path

    @classmethod
    def load(cls, dir_path: str,
             name: str = "configuration") -> "Configuration":
        with open(os.path.join(dir_path, f"{name}.json")) as f:
            return cls(**json.load(f))

    def __repr__(self) -> str:
        keys = ", ".join(sorted(self.__dict__["_values"]))
        return f"Configuration({keys})"
