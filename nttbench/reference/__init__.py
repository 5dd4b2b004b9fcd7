"""Plain references of the benchmark's configurations, one module each,
named by the configuration's ``reference`` key.  They import nothing of
the program under test."""
