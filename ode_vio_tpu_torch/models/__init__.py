"""DeepVIO and its modules, in the reference state_dict layout."""
