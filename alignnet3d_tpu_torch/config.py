"""Config system: recursive-merge JSON -> attribute tree.

The port's own copy of ``alignnet3d_tpu/config.py`` (the port imports
nothing of the JAX package): ``NameSpace``, ``load_config`` and
``config_from_dict`` read the same files into the same tree, so
``ModelSpec.from_config`` sees the same keys in both packages. The schema
and the derived fields (``name``, ``data.basename``, ``logging.logdir``,
``data.ntrain``, ``data.nval``) follow the reference config system
(reference config.py:9-91, configs/default.json).
"""

from __future__ import annotations

import copy
import json
import os

BASE_DIR = os.path.dirname(os.path.abspath(__file__))
_DEFAULT_CONFIG_CANDIDATES = [
    os.path.join(BASE_DIR, "..", "configs", "default.json"),
    os.path.join(BASE_DIR, "configs", "default.json"),
]


def default_config_path() -> str:
    for cand in _DEFAULT_CONFIG_CANDIDATES:
        if os.path.isfile(cand):
            return os.path.abspath(cand)
    raise FileNotFoundError(
        f"default.json not found in any of {_DEFAULT_CONFIG_CANDIDATES}"
    )


class NameSpace:
    """Attribute tree over nested dicts with ``has()`` lookups
    (reference config.py:9-29)."""

    def __repr__(self):
        return "config:\n" + self.repr(4)[:-1]

    def reset(self):
        self.__dict__ = dict()

    def repr(self, indent):
        s = ""
        for k, v in self.__dict__.items():
            if isinstance(v, NameSpace):
                s += "%s%s:\n%s" % (" " * indent, k, v.repr(indent + 4))
            else:
                s += "%s%s: %s\n" % (" " * indent, k, v)
        return s

    def has(self, key) -> bool:
        return key in self.__dict__

    def get(self, key, default=None):
        return self.__dict__.get(key, default)


def dump_to_namespace(ns: NameSpace, d: dict) -> None:
    """Recursive merge of ``d`` into ``ns`` (reference config.py:32-40)."""
    for k, v in d.items():
        if isinstance(v, dict):
            if k not in ns.__dict__:
                ns.__dict__[k] = NameSpace()
            dump_to_namespace(ns.__dict__[k], v)
        else:
            ns.__dict__[k] = copy.deepcopy(v)


def namespace_to_dict(ns: NameSpace, d: dict) -> dict:
    """The attribute tree back to nested dicts, merged into ``d``."""
    for k, v in ns.__dict__.items():
        if isinstance(v, NameSpace):
            d[k] = dict()
            namespace_to_dict(v, d[k])
        else:
            d[k] = v
    return d


# filled by load_config, which the reference's callers read afterwards
configGlobal = NameSpace()


def reset_config() -> None:
    configGlobal.reset()
    with open(default_config_path(), "r") as handle:
        dump_to_namespace(configGlobal, json.load(handle))


def _read_split(path: str):
    with open(path) as f:
        return [int(line.rstrip()) for line in f if line.strip()]


def load_config(filename: str) -> NameSpace:
    """Merge an experiment JSON over the default config and derive fields
    (reference config.py:66-82). Returns ``configGlobal``."""
    if not filename.endswith(".json"):
        raise ValueError(f"config must be a .json file: {filename}")
    reset_config()
    name = os.path.basename(filename)[:-5]
    with open(filename, "r") as handle:
        dump_to_namespace(configGlobal, json.load(handle))
    configGlobal.__dict__["name"] = name
    configGlobal.data.__dict__["basename"] = os.path.basename(
        configGlobal.data.basepath
    )
    configGlobal.logging.__dict__["logdir"] = (
        configGlobal.logging.basedir + f"/{name}"
    )
    if configGlobal.evaluation.has("special"):
        if configGlobal.evaluation.special.mode == "icp":
            configGlobal.logging.__dict__["logdir"] = (
                configGlobal.logging.basedir
                + f"/icp_{configGlobal.data.basename}/{name}"
            )

    split_dir = f"{configGlobal.data.basepath}/split"
    for split_name, key in (("train", "ntrain"), ("val", "nval")):
        split_file = f"{split_dir}/{split_name}.txt"
        # 0 when the split is missing: the failure is deferred to the first
        # data access, so a config loads for serving without its dataset
        configGlobal.data.__dict__[key] = (
            len(_read_split(split_file)) if os.path.isfile(split_file) else 0
        )
    return configGlobal


def save_config(filename: str, cfg: NameSpace | None = None) -> None:
    """Write a config tree (by default the one ``load_config`` filled) as
    JSON (reference config.py:85-88)."""
    if not filename.endswith(".json"):
        raise ValueError(f"config must be a .json file: {filename}")
    with open(filename, "w") as handle:
        json.dump(namespace_to_dict(configGlobal if cfg is None else cfg,
                                    dict()), handle)


def config_from_dict(d: dict) -> NameSpace:
    """A standalone config (default + overrides) that leaves the global
    alone."""
    ns = NameSpace()
    with open(default_config_path(), "r") as handle:
        dump_to_namespace(ns, json.load(handle))
    dump_to_namespace(ns, d)
    return ns
