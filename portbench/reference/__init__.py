"""The plain reference the benchmark's outputs are judged against: torch
and numpy only, nothing of the program under test."""
