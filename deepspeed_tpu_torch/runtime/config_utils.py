"""Typed config base + helpers.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``: plain
dataclass-style classes with dict ingestion, unknown-key warnings and
deprecated-key aliasing, so both packages read the same config dicts the
same way.
"""

import copy
from typing import Any, Dict

from deepspeed_tpu_torch.utils.logging import logger


def get_scalar_param(param_dict: Dict, param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict: Dict, param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_list_param(param_dict: Dict, param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


class DeepSpeedConfigModel:
    """Declarative config: subclasses define class attributes as defaults;
    instances are built from a dict, warning on unknown keys (raising
    under ``strict``)."""

    # map of deprecated key -> new key
    _deprecated_ = {}

    def __init__(self, param_dict: Dict[str, Any] = None, strict: bool = False):
        param_dict = copy.copy(param_dict) or {}
        for old, new in self._deprecated_.items():
            if old in param_dict:
                logger.warning(f"Config key '{old}' is deprecated; use '{new}'")
                param_dict.setdefault(new, param_dict.pop(old))

        cls = type(self)
        known = {k for k in dir(cls)
                 if not k.startswith("_")
                 and not isinstance(getattr(cls, k, None), property)
                 and not callable(getattr(cls, k))}
        for k in known:
            setattr(self, k, copy.deepcopy(getattr(cls, k)))
        for k, v in param_dict.items():
            if k in known:
                setattr(self, k, v)
            else:
                msg = f"Unknown config key '{k}' for {cls.__name__}"
                if strict:
                    raise ValueError(msg)
                logger.warning(msg)
        self._validate()

    def _validate(self):
        pass

    def to_dict(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"
