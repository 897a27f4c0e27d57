"""Arithmetic copied from the program at commit 90524296, frozen here so
that a later change to the program cannot change the yardstick. Each
module names the file it came from."""
