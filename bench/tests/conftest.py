import os
import sys

# the program under test lives in src/ beside the benchmark
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))
