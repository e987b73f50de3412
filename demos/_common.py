"""Shared demo prologue: put the repository root on ``sys.path`` so the
demos run from a checkout without installation."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
