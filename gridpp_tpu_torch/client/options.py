"""key=value option bags (reference src/client/Options.{h,cpp})."""
from __future__ import annotations


class Options:
    def __init__(self, tokens=()):
        self._values: dict[str, str] = {}
        if isinstance(tokens, str):
            tokens = tokens.split()
        for tok in tokens:
            if "=" in tok:
                key, value = tok.split("=", 1)
                self._values[key] = value

    def has(self, key) -> bool:
        return key in self._values

    def get(self, key, default=None, type=str):
        if key not in self._values:
            return default
        raw = self._values[key]
        if type is bool:
            return raw not in ("0", "false", "False")
        return type(raw)

    def get_required(self, key, type=str):
        """Value for a mandatory option (Options::getRequiredValue)."""
        if key not in self._values:
            raise RuntimeError(f"Missing required option '{key}'")
        return self.get(key, type=type)

    def get_floats(self, key, default=()):
        if key not in self._values:
            return list(default)
        return [float(v) for v in self._values[key].split(",")]

    def __repr__(self):
        return f"Options({self._values})"
