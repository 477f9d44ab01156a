"""JobConfig: the reference's flat properties-file configuration system.

Same file format and key names as the reference (reference:
src/main/java/com/linkedin/mapred/JobConfig.java:21-243; full key list in
README.md:179-205): java-properties `key=value` lines, `#` comments, typed
getters with defaults or an error when a required key is missing, and
clone+put for sub-job rewiring (Regression.java:50-77).
"""

from __future__ import annotations


class ConfigError(KeyError):
    pass


class JobConfig(dict):
    @classmethod
    def from_file(cls, path: str) -> "JobConfig":
        cfg = cls()
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#") or line.startswith("!"):
                    continue
                if "=" in line:
                    key, _, value = line.partition("=")
                elif ":" in line:
                    key, _, value = line.partition(":")
                else:
                    continue
                cfg[key.strip()] = value.strip()
        return cfg

    def clone(self) -> "JobConfig":
        return JobConfig(self)

    def put(self, key: str, value) -> None:
        """clone()+put is the reference's sub-job rewiring idiom
        (Regression.java:50-77)."""
        self[key] = str(value)

    # -- typed getters ---------------------------------------------------
    def _get(self, key: str, default):
        if key in self:
            return self[key]
        if default is _REQUIRED:
            raise ConfigError(f"Please specify {key} in the job config file!")
        return default

    def get_string(self, key: str, default=None) -> str:
        v = self._get(key, _REQUIRED if default is None else default)
        return str(v)

    def get_int(self, key: str, default=None) -> int:
        v = self._get(key, _REQUIRED if default is None else default)
        return int(str(v))

    def get_float(self, key: str, default=None) -> float:
        v = self._get(key, _REQUIRED if default is None else default)
        return float(str(v))

    get_double = get_float

    def get_boolean(self, key: str, default=None) -> bool:
        v = self._get(key, _REQUIRED if default is None else default)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() == "true"

    def get_string_list(self, key: str, default=None, sep: str = ",") -> list[str]:
        if key not in self:
            if default is None:
                raise ConfigError(f"Please specify {key} in the job config file!")
            return list(default)
        return [t.strip() for t in str(self[key]).split(sep) if t.strip()]

    def get_float_list(self, key: str, default=None, sep: str = ",") -> list[float]:
        lst = self.get_string_list(key, default=None if default is None
                                   else [str(x) for x in default], sep=sep)
        return [float(x) for x in lst]


class _Required:
    pass


_REQUIRED = _Required()
