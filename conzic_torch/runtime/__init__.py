"""Host-side runtime: image preprocessing, seeding, logging, profiling and
the prefetch pipeline of the command-line entry points."""
