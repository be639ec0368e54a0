"""Communication accounting (the serving part so far)."""
