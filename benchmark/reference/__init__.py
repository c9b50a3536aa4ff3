"""The plain reference of the check (``plain``). It imports nothing of
the program."""
