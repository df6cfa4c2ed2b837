# The sibling ml010_reaches_jax imports: it imports jax directly, which the
# port never does.
# PINNED: ML010 must fire here (and nothing else may).
import jax  # noqa: F401
