"""The plain float32 reference models, one module a configuration's
`reference` key names; each gives `spec`, `eps_shapes`, `loss` and
`recurrences` (its step's recurrence calls, for the bounds and the FLOP
count).  They import nothing of the program."""
