"""The attribute dict the configs are made of, and ``merge_dict`` (a copy
of ``exposure_tpu/utils/dict_util.py``)."""


class Dict(dict):
    """A dict whose items are also attributes.

    >>> d = Dict(a=1); d.b = 2; (d.a, d['b'])
    (1, 2)
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __getattr__(self, attr):
        try:
            return self[attr]
        except KeyError as e:
            raise AttributeError(attr) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, item):
        del self[item]

    def copy(self):
        return Dict(self)


def merge_dict(a, b):
    """A copy of ``a`` with ``b``'s items added; a key in both raises
    ``KeyError``."""
    ret = a.copy()
    for key, val in b.items():
        if key in ret:
            raise KeyError("Item %r already exists" % key)
        ret[key] = val
    return ret
