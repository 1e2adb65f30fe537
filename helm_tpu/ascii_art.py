"""Startup banner (reference: src/ascii.rs)."""

BANNER = r"""
  _  _ ___ _    __  __     _____ ___ _   _
 | || | __| |  |  \/  |___|_   _| _ \ | | |
 | __ | _|| |__| |\/| |___| | | |  _/ |_| |
 |_||_|___|____|_|  |_|     |_| |_|  \___/
   encrypted circuit evaluation through gates and lookups
"""


def print_art() -> None:
    print("\x1b[36m" + BANNER + "\x1b[0m")
