"""AttrDict: dict with attribute access and an immutability switch (the
port's copy of detectron_tpu/utils/collections.py, the container behind its
own cfg).

Mirrors the behavior of the reference's lib/utils/collections.py :: AttrDict
(the container behind the global `cfg`), re-implemented from scratch.
"""


class AttrDict(dict):
    IMMUTABLE = "__immutable__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[AttrDict.IMMUTABLE] = False

    def __getattr__(self, name):
        if name in self.__dict__:
            return self.__dict__[name]
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if not self.__dict__[AttrDict.IMMUTABLE]:
            if name in self.__dict__:
                self.__dict__[name] = value
            else:
                self[name] = value
        else:
            raise AttributeError(
                "Attempted to set '{}' to '{}', but AttrDict is immutable".format(
                    name, value
                )
            )

    def immutable(self, is_immutable):
        """Set immutability recursively for this AttrDict and all nested ones."""
        self.__dict__[AttrDict.IMMUTABLE] = is_immutable
        for v in self.__dict__.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)

    def is_immutable(self):
        return self.__dict__[AttrDict.IMMUTABLE]
