"""Plain references, one per configuration ``reference``; none imports the program."""
