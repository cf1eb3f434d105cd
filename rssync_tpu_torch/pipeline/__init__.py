"""The batched syncpoint run (ref: src/core_testcode.cpp:270-316)."""
