"""The general generators that traffic files name by ``generator``."""
