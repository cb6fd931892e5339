"""The plain float32 reference and the comparison that decides `correct`.
Imports nothing of the system under test."""
