"""One module per kind of traffic, named by a mix's "driver"; each has
`run(ctx) -> record` (`portbench.run.RunContext`)."""
