// K5's parallel sweep at block sizes above 16 (bmax 32, 64 and 128), built
// from stagewise.cu as a library of its own so that nvcc compiles it beside
// the other parts (PHC_SW_PART and PHC_SW_PAR there).
#define PHC_SW_PART 1
#define PHC_SW_PAR 1
#include "stagewise.cu"
