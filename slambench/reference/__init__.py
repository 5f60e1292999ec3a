"""The plain reference that decides `correct`: plain torch and numpy,
importing nothing of the program."""
