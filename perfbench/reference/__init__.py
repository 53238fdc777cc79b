"""Plain reference optimizers, one module a reference named by a
configuration; they import nothing of the program."""
