"""Terminal input for the interactive play CLI.

Counterpart of ``playablevideogeneration_tpu/utils/input_helper.py``: one
raw keypress at a time on a tty, and the first character of each line when
the input is a pipe or a file, so scripted sessions and tests drive the
same loop.  The terminal's settings are restored on every exit path, and
Ctrl-C / Ctrl-D in raw mode read as ``"q"``, so the caller's quit path
runs.
"""
from __future__ import annotations

import sys


class InputHelper:
    """Reads single characters from ``stream`` (default: stdin).

    :param interactive: on a tty, deliver each keypress at once (raw mode,
        no ENTER); otherwise, and on anything that is not a tty, read a
        line and return its first character
    """

    def __init__(self, interactive: bool = True, stream=None):
        self.stream = stream if stream is not None else sys.stdin
        self.interactive = bool(interactive) and self._is_tty()

    def _is_tty(self) -> bool:
        try:
            return self.stream.isatty()
        except (AttributeError, ValueError):
            return False

    def read_character(self) -> str:
        """The next character typed; an empty string at the end of input,
        ``"\\n"`` for an empty line."""
        if not self.interactive:
            try:
                line = self.stream.readline()
            except (EOFError, ValueError):
                return ""
            if line == "":
                return ""
            return line.strip()[:1] or "\n"

        import termios
        import tty

        fd = self.stream.fileno()
        old_settings = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            ch = self.stream.read(1)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old_settings)
        if ch in ("\x03", "\x04"):  # Ctrl-C / Ctrl-D -> quit
            return "q"
        return ch
