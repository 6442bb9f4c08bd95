"""Typed settings from the reference's YAML configs: not ported yet.

The reference's `orbslam3_tpu/config.py` reads OpenCV-FileStorage YAML
through PyYAML, which the machine with the card does not have. Until the
port parses that YAML subset itself (ROADMAP slice B), build `SystemConfig`,
`Camera` and `ImuCalib` in code, as `chip_smoke.py` does.
"""

from __future__ import annotations


class Settings:
    @staticmethod
    def from_yaml(path: str, sensor: str = "monocular") -> "Settings":
        raise NotImplementedError("Settings.from_yaml: the YAML settings loader is "
                                  "ROADMAP slice B, not yet ported")
