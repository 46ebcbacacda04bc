"""Drivers: one per configuration ``entry``, each building the program."""
