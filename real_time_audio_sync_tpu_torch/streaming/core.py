"""App scaffold — ims/core.py parity without Kivy.

``BaseWidget``'s role (per-frame ``on_update`` + key hooks, ims/core.py:21-73)
is played by :class:`AppLoop`; ``register_terminate_func``/``run`` keep the
reference's crash-safe-teardown contract (ims/core.py:79-102): registered
terminate functions run even when the app body raises.
"""

from __future__ import annotations

import traceback
from typing import Callable, List, Optional

_terminate_funcs: List[Callable[[], None]] = []


def register_terminate_func(fn: Callable[[], None]) -> None:
    """Register cleanup to run when the app exits, crash included
    (ims/core.py:79-82)."""
    _terminate_funcs.append(fn)


def run(app: "AppLoop") -> None:
    """Run an app; terminate funcs always execute (ims/core.py:85-102)."""
    try:
        app.main()
    except Exception:
        traceback.print_exc()
    finally:
        for fn in _terminate_funcs:
            try:
                fn()
            except Exception:
                traceback.print_exc()
        _terminate_funcs.clear()


class AppLoop:
    """Minimal app base: override :meth:`main`, or :meth:`on_update` /
    :meth:`on_key_down` and drive with :meth:`pump`."""

    def main(self) -> None:
        raise NotImplementedError

    def on_update(self) -> None:  # per-frame hook (ims/core.py:72-73)
        pass

    def on_key_down(self, keycode: str, modifiers: Optional[list] = None) -> None:
        pass

    def pump(self, keys: str = "") -> None:
        """One frame: deliver queued keys then the update hook."""
        for k in keys:
            self.on_key_down(k)
        self.on_update()


def lookup(k, keys, values):
    """ims/core.py:107-112 utility: parallel-sequence lookup."""
    if k in keys:
        return values[keys.index(k)]
    return None
