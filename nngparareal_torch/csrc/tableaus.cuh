// The Butcher tableaus the fan-out kernels are compiled for.
// Generated from nngparareal_torch/ops/butcher.py by
//     python -m nngparareal_torch.ops.butcher > nngparareal_torch/csrc/tableaus.cuh
// Each coefficient is float.hex() of butcher.py's value: bitwise the
// Python double. Do not edit by hand.
#pragma once

namespace tableau {

struct RK1 {
    static constexpr int id = 0;
    static constexpr int S = 1;
    static constexpr double a[S][S] = {
        {0x0.0p+0},
    };
    static constexpr double b[S] = {0x1.0000000000000p+0};
    static constexpr int nz_a[S][S] = {
        {0},
    };
    static constexpr int nz_b[S] = {1};
};

struct RK2 {
    static constexpr int id = 1;
    static constexpr int S = 2;
    static constexpr double a[S][S] = {
        {0x0.0p+0, 0x0.0p+0},
        {0x1.0000000000000p-1, 0x0.0p+0},
    };
    static constexpr double b[S] = {0x0.0p+0, 0x1.0000000000000p+0};
    static constexpr int nz_a[S][S] = {
        {0, 0},
        {1, 0},
    };
    static constexpr int nz_b[S] = {0, 1};
};

struct RK4 {
    static constexpr int id = 2;
    static constexpr int S = 4;
    static constexpr double a[S][S] = {
        {0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.0000000000000p-1, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x0.0p+0, 0x1.0000000000000p-1, 0x0.0p+0, 0x0.0p+0},
        {0x0.0p+0, 0x0.0p+0, 0x1.0000000000000p+0, 0x0.0p+0},
    };
    static constexpr double b[S] = {0x1.5555555555555p-3, 0x1.5555555555555p-2, 0x1.5555555555555p-2, 0x1.5555555555555p-3};
    static constexpr int nz_a[S][S] = {
        {0, 0, 0, 0},
        {1, 0, 0, 0},
        {0, 1, 0, 0},
        {0, 0, 1, 0},
    };
    static constexpr int nz_b[S] = {1, 1, 1, 1};
};

struct RK8 {
    static constexpr int id = 3;
    static constexpr int S = 11;
    static constexpr double a[S][S] = {
        {0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.0000000000000p-1, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.0000000000000p-2, 0x1.0000000000000p-2, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.2492492492492p-3, -0x1.b195cca340900p-3, 0x1.cad842e9913b0p-1, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.7beb04681f33ep-3, 0x0.0p+0, 0x1.27417bb787106p-1, 0x1.0ad929c2b65f7p-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.98db47b6369adp-3, 0x0.0p+0, 0x1.82594c40962e5p-2, -0x1.da940cb6a5369p-2, 0x1.8bcd1c9af3badp-2, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.0829f72fc1982p-3, 0x0.0p+0, -0x1.0e8b8460f0c4bp-5, -0x1.6619247fe45f5p-2, 0x1.5066d0fa779f1p-2, 0x1.910011977ae2cp-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.2492492492492p-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.066d8aec55c72p-9, -0x1.84e9bc91f59e8p-7, 0x1.c71c71c71c71cp-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.0000000000000p-5, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.29c2f45fc00d5p-7, 0x1.38e38e38e38e4p-3, -0x1.43dd1722cc702p-1, 0x1.ea4b3f66128ccp-1, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0},
        {0x1.2492492492492p-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.c71c71c71c71cp-4, -0x1.469ef01c47156p-1, 0x1.03fa884516df4p+1, -0x1.cf94b916c05b2p+0, 0x1.0fffe5f0ee105p+0, 0x0.0p+0, 0x0.0p+0},
        {0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.1a3994e68f664p-1, 0x1.39c6d581a481cp+1, -0x1.ca8e90f5a3677p+2, 0x1.e3721f2e86f5bp+2, -0x1.1d550e6532babp+1, 0x1.e15606adabd80p-1, 0x0.0p+0},
    };
    static constexpr double b[S] = {0x1.999999999999ap-5, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.16c16c16c16c1p-2, 0x1.6c16c16c16c17p-2, 0x1.16c16c16c16c1p-2, 0x1.999999999999ap-5};
    static constexpr int nz_a[S][S] = {
        {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
        {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
        {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
        {1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
        {1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0},
        {1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0},
        {1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0},
        {1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0},
        {1, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0},
        {1, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0},
        {0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0},
    };
    static constexpr int nz_b[S] = {1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1};
};

}  // namespace tableau
