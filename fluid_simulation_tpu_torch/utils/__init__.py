"""The program's spans (``profiling``)."""
