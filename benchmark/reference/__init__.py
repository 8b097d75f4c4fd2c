"""The plain reference: the inputs, brute-force k-mers, meryl's rules
and the DB format.  It imports nothing of the program."""
