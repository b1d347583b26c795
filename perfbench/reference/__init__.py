"""Plain float32 references of the configurations, independent of the
program."""
