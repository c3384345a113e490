"""The plain float32 reference models, one module a configuration's
`reference` key names; each gives `spec`, `eps_shapes` and `loss`.  They
import nothing of the program."""
