"""The loops a traffic mix names by its ``driver`` key: each builds the
program and its inputs (set-up), runs the measured window, frees the program
and compares what the window produced with the plain reference."""
