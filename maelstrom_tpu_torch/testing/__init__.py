"""Seeded history generators shared by the tests and the checker bench."""
