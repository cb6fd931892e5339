"""The modules that drive a cell, one per traffic mix's `entry`, loaded by
name (`harness.load_module("entries", <entry>)`)."""
