"""Logical-axis sharding rules of the port (the reference's
`repro.sharding`)."""
