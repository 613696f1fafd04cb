"""Multi-device code: logical-axis sharding rules, the sequence-sharded
decode attention and the int8 gradient all-reduce."""
