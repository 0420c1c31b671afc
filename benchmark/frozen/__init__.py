"""Frozen copies of the program's generators and arithmetic.

Each module names the file and commit it was copied from.  Later changes
to the program leave these copies as they are, so the inputs and the
arithmetic of the yardstick stay fixed.
"""
