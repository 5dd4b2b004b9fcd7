"""How the benchmark builds the system under test, one module a kind of
system, named by a configuration's ``system`` key.  These modules are the
only part of the benchmark that imports the program."""
