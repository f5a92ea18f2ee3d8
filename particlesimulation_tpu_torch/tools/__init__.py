"""Measurement tools of the port that are not part of its main path,
run on the card (see each module's docstring)."""
