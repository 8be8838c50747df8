"""Flatten nested config dicts for hyperparameter logging (a copy of the
JAX package's config/flatten_dict.py; ref:
nr4seg/utils/flatten_dict.py:6-18)."""

import collections.abc


def flatten_dict(d: dict, parent_key: str = "", sep: str = ".") -> dict:
    items = []
    for k, v in d.items():
        new_key = parent_key + sep + str(k) if parent_key else str(k)
        if isinstance(v, collections.abc.MutableMapping):
            items.extend(flatten_dict(v, new_key, sep=sep).items())
        elif isinstance(v, list):
            if all(isinstance(x, (int, float, str, bool)) for x in v):
                items.append((new_key, v))
            else:
                for i, x in enumerate(v):
                    if isinstance(x, collections.abc.MutableMapping):
                        items.extend(
                            flatten_dict(x, f"{new_key}{sep}{i}", sep=sep).items())
                    else:
                        items.append((f"{new_key}{sep}{i}", str(x)))
        else:
            items.append((new_key, v))
    return dict(items)
